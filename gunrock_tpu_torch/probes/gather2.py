"""Gather shape limits and rates (the port's counterpart of
``benchmarks/probe_gather2.py``), through ``ops/kernels/probes.gather``.

Variants, with the JAX probe's draws (one ``default_rng(1)`` per run):
  wide       lane gather [8, 256], idx in [0, 256)
  tall       sublane gather [32, 128], idx in [0, 32)
  big        lane gather [1024, 128], idx in [0, 128)
  bench      rate of the [4096, 128] lane gather
  bench_sub  rate of the [4096, 128] sublane gather, idx in [0, 4096)
Each is held against numpy's ``take_along_axis``, exactly. The rates time
the gather on its fixed indices (the JAX probe chains each output back
into the next call's indices, which times its conversion ops as well).

Usage: python -m gunrock_tpu_torch.probes.gather2 [variant|all] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gunrock_tpu_torch.device import resolve
from gunrock_tpu_torch.probes import bench_rates, device_label

VARIANTS = ("wide", "tall", "big", "bench", "bench_sub")
# variant: (shape, idx bound, axis)
SHAPES = {
    "wide": ((8, 256), 256, 1),
    "tall": ((32, 128), 32, 0),
    "big": ((1024, 128), 128, 1),
    "bench": ((4096, 128), 128, 1),
    "bench_sub": ((4096, 128), 4096, 0),
}
BENCH_RUNS = 50


def inputs(variant: str, rng=None):
    """(x, idx, axis) of ``variant``, drawn from ``rng`` (a fresh
    ``default_rng(1)`` when None, as one JAX probe run starts)."""
    if variant not in SHAPES:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    rng = np.random.default_rng(1) if rng is None else rng
    shape, hi, axis = SHAPES[variant]
    x = rng.standard_normal(shape, dtype=np.float32)
    idx = rng.integers(0, hi, shape, dtype=np.int32)
    return x, idx, axis


def run_variant(variant: str, device="cuda") -> dict:
    """Gather ``variant``'s inputs on ``device``, check against numpy's
    ``take_along_axis`` exactly, and (the bench variants) time it."""
    from gunrock_tpu_torch.ops.kernels.probes import gather

    device = resolve(device)  # raises without a card
    x, idx, axis = inputs(variant)
    tx = torch.from_numpy(x).to(device)
    tidx = torch.from_numpy(idx).to(device)
    out = gather(tx, tidx, axis).cpu().numpy()
    np.testing.assert_array_equal(out, np.take_along_axis(x, idx, axis=axis))
    row = {"probe": variant, "ok": True, "shape": list(idx.shape),
           "device": device_label(device)}
    if variant.startswith("bench"):
        row.update(bench_rates(device, lambda: gather(tx, tidx, axis),
                               tx, tidx, axis, BENCH_RUNS))
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.gather2")
    p.add_argument("variant", nargs="?", default="all",
                   choices=(*VARIANTS, "all"))
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    for v in VARIANTS if ns.variant == "all" else (ns.variant,):
        print(json.dumps(run_variant(v, ns.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
