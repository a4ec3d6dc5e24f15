"""Device selection and the card's properties (the port's counterpart of
``gunrock_tpu/device``).

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking for
CUDA where there is no card raises instead of running on the CPU; the CPU
runs only when the caller asks for it (``device="cpu"``), and there each
kernel wrapper runs its plain PyTorch version.

:mod:`gunrock_tpu_torch.device.properties` reads what the card is (name,
SMs, memories, power limit) and carries its published peaks, for the
roofline and the exported metrics.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


from gunrock_tpu_torch.device.properties import (  # noqa: E402,F401
    DeviceProperties,
    LaunchParams,
    get_device_properties,
    launch_params,
)
