"""The async block-copy pattern a streaming semiring kernel needs (the
port's counterpart of ``benchmarks/probe_dma.py``), through
``ops/kernels/probes.block_copy_sum``: indices staged on chip, blocks
copied from device memory by the Tensor Memory Accelerator as each index
names them, and summed.

Variants:
  check  the JAX probe's case: x = arange(4*8*128) as [4, 8, 128], meta =
         16 draws of default_rng(0) in [0, 4), cnt = 16; prints expect
         (the float64 sum), got, and MATCH where |got - expect| < 1 (the
         JAX probe's test); fails beyond rtol 1e-6 (f32 sums above 2^24
         round to even steps)
  bench  the main path's shape: one W=2048 x-window (8 KB) per chunk of
         the unit pull layout of R-MAT ``--scale`` (edge factor 16, seed
         1, degree-sorted), in its chunk_cb order; the copy rate in GB/s
         beside the same sum by ``x.view(-1, W)[meta].sum()`` and the
         card's memory rate

Usage: python -m gunrock_tpu_torch.probes.dma [check|bench|all]
       [--scale 18] [--num_runs 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gunrock_tpu_torch.device import resolve
from gunrock_tpu_torch.device.properties import get_device_properties
from gunrock_tpu_torch.probes import device_label, device_ms, time_ms

VARIANTS = ("check", "bench")


def check_inputs():
    """(x, meta, cnt) of the JAX probe, as numpy arrays."""
    n_blocks, n_chunks = 4, 16
    meta = np.random.default_rng(0).integers(0, n_blocks, n_chunks).astype(np.int32)
    x = np.arange(n_blocks * 8 * 128, dtype=np.float32).reshape(n_blocks, 8, 128)
    return x, meta, np.asarray([n_chunks], np.int32)


def check(device="cuda") -> dict:
    """The JAX probe's case on ``device``; raises beyond rtol 1e-6 of the
    float64 sum."""
    from gunrock_tpu_torch.ops.kernels.probes import block_copy_sum

    device = resolve(device)  # raises without a card
    x, meta, cnt = check_inputs()
    y = block_copy_sum(*(torch.from_numpy(a).to(device) for a in (x, meta, cnt)))
    expect = sum(float(x[int(b)].astype(np.float64).sum()) for b in meta)
    got = float(y[0, 0, 0])
    if not bool((y == y[0, 0, 0]).all()):
        raise AssertionError("block copy: y is not filled with one total")
    print("expect", expect, "got", got,
          "MATCH" if abs(expect - got) < 1 else "MISMATCH")
    if abs(expect - got) > 1e-6 * abs(expect):
        raise AssertionError(f"block copy: got {got}, expected {expect}")
    return {"probe": "dma_check", "ok": True, "expect": expect, "got": got,
            "device": device_label(device)}


def window_inputs(layout):
    """(x, meta, cnt) of the main path's shape: the vertex vector padded to
    whole W-windows as [n_col_blocks, W/128, 128] blocks, and the layout's
    chunk_cb (one window per chunk)."""
    W = layout.window
    gen = torch.Generator(device=layout.device).manual_seed(0)
    x = torch.rand((layout.n_col_blocks, W // 128, 128), generator=gen,
                   device=layout.device)
    meta = layout.chunk_cb.contiguous()
    cnt = torch.tensor([layout.n_chunks], dtype=torch.int32, device=layout.device)
    return x, meta, cnt


def bench(layout, num_runs: int = 20) -> dict:
    """Copy and sum one x-window per chunk of ``layout``: the rate of the
    copies beside ``x.view(-1, W)[meta].sum()`` (two PyTorch calls); the
    sum is held within rtol 1e-5 of the float64 sum."""
    from gunrock_tpu_torch.ops.kernels.probes import block_copy_sum

    x, meta, cnt = window_inputs(layout)
    dev = layout.device
    got = float(block_copy_sum(x, meta, cnt)[0, 0, 0])
    yard = lambda: x.view(x.shape[0], -1)[meta.long()].sum()  # noqa: E731
    want = float(x.view(x.shape[0], -1).double()[meta.long()].sum())
    if abs(got - want) > 1e-5 * abs(want):
        raise AssertionError(f"block copy: {got} against {want}")
    copied = layout.n_chunks * x[0].numel() * 4
    row = {"probe": "dma_bench", "ok": True, "copies": layout.n_chunks,
           "block_bytes": x[0].numel() * 4, "device": device_label(dev)}
    peak = get_device_properties(dev).peak_bytes_per_s
    for key, fn in (("", lambda: block_copy_sum(x, meta, cnt)),
                    ("yardstick_", yard)):
        row[f"{key}ms"] = time_ms(dev, fn, num_runs)
        row[f"{key}device_ms"] = device_ms(dev, fn, num_runs)
        # the rate of the copies, by wall time and by the card's busy time
        for sfx, t in (("", row[f"{key}ms"]), ("_device", row[f"{key}device_ms"])):
            if isinstance(t, str):
                continue
            row[f"{key}gbps{sfx}"] = copied / (t / 1e3) / 1e9
            if peak:
                row[f"{key}pct_peak_bw{sfx}"] = 100.0 * copied / (t / 1e3) / peak
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.dma")
    p.add_argument("variant", nargs="?", default="all",
                   choices=(*VARIANTS, "all"))
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--num_runs", type=int, default=20)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    if ns.variant in ("check", "all"):
        print(json.dumps(check(ns.device)), flush=True)
    if ns.variant in ("bench", "all"):
        from gunrock_tpu_torch.ops.kernels.layout import pull_layout
        from gunrock_tpu_torch.probes.v5_floor import probe_graph

        graph = probe_graph(ns.scale, ns.device)
        print(json.dumps(bench(pull_layout(graph, unit=True), ns.num_runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
