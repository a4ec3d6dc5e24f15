"""The benchmark of the port, ``gunrock_tpu_torch``: see README.md."""
