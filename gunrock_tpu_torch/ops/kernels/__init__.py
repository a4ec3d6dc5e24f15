"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module wraps one kernel of ``csrc/`` (built at first use by
``_build``) and holds the plain version beside it. A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
or raises.
"""
