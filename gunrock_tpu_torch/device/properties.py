"""What the card is, and the launch parameters the port's layouts take.

Counterpart of ``gunrock_tpu/device/properties.py``: there a TPU
generation table (HBM, VMEM, MXU size) and per-generation window/chunk
picks; here ``torch.cuda.get_device_properties`` (SMs, memory, L2, shared
memory, registers, warp size), the power limit as ``nvidia-smi`` reports
it, and the card's published peaks, which the roofline divides by.

Peaks are known by card name only. A card missing from ``_PEAKS`` has
none (``None``: not measured), never another card's; the CPU entry, for
the tests, has none either.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess

# name as torch.cuda.get_device_name gives it: (bytes/s, f32 FLOP/s outside
# the tensor cores). NVIDIA's H100 SXM data sheet, at its 700 W limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}
NOT_MEASURED = "not measured"


@dataclasses.dataclass(frozen=True)
class DeviceProperties:
    """The numbers kernels and measurements are held against (role of the
    reference ``gcuda::device_properties_t``). Sizes in bytes; ``None``
    where the device has no such thing or it was not read (the CPU)."""

    name: str  # torch.cuda.get_device_name, or "cpu"
    platform: str  # "gpu" | "cpu"
    num_devices: int
    sm_count: int | None
    memory_bytes: int | None
    l2_bytes: int | None
    smem_per_block: int | None
    smem_per_sm: int | None
    regs_per_sm: int | None
    warp_size: int | None
    power_limit: str  # nvidia-smi's "700.00 W", or "not measured"
    peak_bytes_per_s: float | None
    peak_f32_per_s: float | None

    @property
    def name_power_limit(self) -> str:
        """The card's name and power limit, as written beside every time."""
        return f"{self.name}, {self.power_limit}"


def _smi_power_limit(index: int) -> str:
    """Power limit of card ``index`` as nvidia-smi reports it; "not
    measured" where nvidia-smi does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return NOT_MEASURED
    if index >= len(out) or "," not in out[index]:
        return NOT_MEASURED
    return out[index].rsplit(",", 1)[1].strip()


@functools.lru_cache(maxsize=None)
def _cuda_properties(index: int) -> DeviceProperties:
    import torch

    p = torch.cuda.get_device_properties(index)
    name = torch.cuda.get_device_name(index)
    peaks = _PEAKS.get(name, (None, None))
    return DeviceProperties(
        name=name,
        platform="gpu",
        num_devices=torch.cuda.device_count(),
        sm_count=p.multi_processor_count,
        memory_bytes=p.total_memory,
        l2_bytes=getattr(p, "L2_cache_size", None),
        smem_per_block=getattr(p, "shared_memory_per_block", None),
        smem_per_sm=getattr(p, "shared_memory_per_multiprocessor", None),
        regs_per_sm=getattr(p, "regs_per_multiprocessor", None),
        warp_size=getattr(p, "warp_size", None),
        power_limit=_smi_power_limit(index),
        peak_bytes_per_s=peaks[0],
        peak_f32_per_s=peaks[1],
    )


CPU = DeviceProperties(
    name="cpu", platform="cpu", num_devices=1, sm_count=None,
    memory_bytes=None, l2_bytes=None, smem_per_block=None, smem_per_sm=None,
    regs_per_sm=None, warp_size=None, power_limit=NOT_MEASURED,
    peak_bytes_per_s=None, peak_f32_per_s=None,
)


def get_device_properties(device="cuda") -> DeviceProperties:
    """Properties of ``device`` (default: the current card). Raises
    without a card unless ``device="cpu"``, whose entry has no peaks."""
    import torch

    from gunrock_tpu_torch.device import resolve

    dev = resolve(device)
    if dev.type == "cpu":
        return CPU
    if dev.type != "cuda":
        raise ValueError(f"no properties for device {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _cuda_properties(index)


@dataclasses.dataclass(frozen=True)
class LaunchParams:
    """Role of reference ``launch_box_t``: the window and chunk a kernel's
    layout is built at."""

    window: int  # vertex window per bucket
    chunk: int  # slots per chunk


# the algorithms that build their layout at dense_window_chunk's pick
_DENSE_ONLY = ("pr", "hits")


def launch_params(kernel: str = "semiring",
                  n_vertices: int | None = None) -> LaunchParams:
    """The window and chunk the port's layouts take for ``kernel``:
    W=2048/C=256 for the pull and push layouts, and for the dense-only
    algorithms (``"pr"``, ``"hits"``) with ``n_vertices`` given, the pick
    of ``layout.dense_window_chunk`` (W=4096/C=1024 for 2^16 <= V <= 2^20).
    It reports what the layouts take and tunes nothing."""
    from gunrock_tpu_torch.ops.kernels.layout import CHUNK, WINDOW, dense_window_chunk

    if kernel in _DENSE_ONLY and n_vertices is not None:
        pick = dense_window_chunk(n_vertices)
        if pick is not None:
            return LaunchParams(window=pick[0], chunk=pick[1])
    return LaunchParams(window=WINDOW, chunk=CHUNK)
