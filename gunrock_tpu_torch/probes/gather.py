"""Gathers at the TPU probe's shapes (the port's counterpart of
``benchmarks/probe_gather.py``), through ``ops/kernels/probes.gather``.

Variants, with the JAX probe's inputs (``default_rng(0)`` draws):
  lane      out[i, j] = x[i, idx[i, j]]       take_along_axis axis=1, [8, 128]
  sublane   out[i, j] = x[idx[i, j], j]       take_along_axis axis=0, [8, 128]
  flat      out[j]    = x[idx[j]]             256 from 2048
  twolevel  x[idx] of C=256 from a W=2048 window, as [2, 128] (the TPU's
            one-hot two-level gather; on the card the plain flat gather)
  bench     rate of [512, 8, 128] take_along_axis on axis 2
Each is held against numpy's result, exactly.

Usage: python -m gunrock_tpu_torch.probes.gather [variant|all] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gunrock_tpu_torch.device import resolve
from gunrock_tpu_torch.probes import bench_rates, device_label

VARIANTS = ("lane", "sublane", "flat", "twolevel", "bench")
BENCH_RUNS = 30


def inputs(variant: str):
    """(x, idx, axis, numpy reference) of ``variant``: the JAX probe's
    draws, in its order."""
    rng = np.random.default_rng(0)
    if variant in ("lane", "sublane"):
        x = rng.standard_normal((8, 128), dtype=np.float32)
        hi, axis = (128, 1) if variant == "lane" else (8, 0)
        idx = rng.integers(0, hi, (8, 128), dtype=np.int32)
        return x, idx, axis, np.take_along_axis(x, idx, axis=axis)
    if variant == "flat":
        x = rng.standard_normal((2048,), dtype=np.float32)
        idx = rng.integers(0, 2048, (256,), dtype=np.int32)
        return x, idx, None, x[idx]
    if variant == "twolevel":
        W, C = 2048, 256
        x = rng.standard_normal((W,), dtype=np.float32)
        idx = rng.integers(0, W, (C,), dtype=np.int32).reshape(2, 128)
        return x, idx, None, x[idx]
    if variant == "bench":
        R = 512
        x = rng.standard_normal((R, 8, 128), dtype=np.float32)
        idx = rng.integers(0, 128, (R, 8, 128), dtype=np.int32)
        return x, idx, 2, np.take_along_axis(x, idx, axis=2)
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def run_variant(variant: str, device="cuda") -> dict:
    """Gather ``variant``'s inputs on ``device``, check the result against
    numpy's exactly, and (``bench``) time it."""
    from gunrock_tpu_torch.ops.kernels.probes import gather

    device = resolve(device)  # raises without a card
    x, idx, axis, ref = inputs(variant)
    tx = torch.from_numpy(x).to(device)
    tidx = torch.from_numpy(idx).to(device)
    out = gather(tx, tidx, axis).cpu().numpy()
    np.testing.assert_array_equal(out, ref)
    row = {"probe": f"gather_{variant}", "ok": True,
           "shape": list(idx.shape), "device": device_label(device)}
    if variant == "bench":
        row.update(bench_rates(device, lambda: gather(tx, tidx, axis),
                               tx, tidx, axis, BENCH_RUNS))
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.gather")
    p.add_argument("variant", nargs="?", default="all",
                   choices=(*VARIANTS, "all"))
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    for v in VARIANTS if ns.variant == "all" else (ns.variant,):
        print(json.dumps(run_variant(v, ns.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
