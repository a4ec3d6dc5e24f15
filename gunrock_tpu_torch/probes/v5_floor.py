"""Split the dense semiring pass into stream, gather and scatter (the
port's counterpart of ``benchmarks/probe_v5_floor.py``).

Variants, one line each, with the same grid, loop and loads:
  dma      the chunks stream through; each sums its values (row and col
           loaded, weighted 0): the floor of the stream alone
  gather   + the gather of x (each chunk sums val * x[col]; no scatter)
  full     the dense pass itself (``bucketed_semiring_spmv``)
so gather - dma is the gather's time and full - gather the scatter's. The
``split`` line adds the card's bound for the real slots (12 B each) plus x
and y.

Usage: python -m gunrock_tpu_torch.probes.v5_floor [dma|gather|full|all]
       [--scale 18] [--window 2048] [--chunk 256] [--num_runs 20]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gunrock_tpu_torch.probes import device_label, device_ms, time_ms

VARIANTS = ("dma", "gather", "full")


def probe_graph(scale: int, device="cuda"):
    """The probe's graph: R-MAT ``scale``, edge factor 16, seed 1,
    degree-sorted, as the JAX probe builds it."""
    from gunrock_tpu_torch.graph.reorder import degree_sort
    from gunrock_tpu_torch.io.generators import rmat_graph

    return degree_sort(rmat_graph(scale, 16, seed=1, device=device))[0]


def probe_inputs(layout, num_runs: int) -> list:
    """The JAX probe's x vectors: ``num_runs`` draws of
    ``default_rng(0).random(V)`` in f32, on the layout's device."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.random(layout.n_vertices, dtype=np.float32))
            .to(layout.device) for _ in range(num_runs)]


def variant_fn(layout, variant: str):
    """The call the variant times, on one x."""
    from gunrock_tpu_torch.ops.kernels import probes, semiring

    if variant == "full":
        return lambda x: semiring.bucketed_semiring_spmv(layout, x, "plus_times")
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return lambda x: probes.spmv_floor(layout, x, variant)


def run_variant(layout, n_edges: int, variant: str, xs: list,
                scale: int | None = None) -> dict:
    """Time ``variant`` over the calls on ``xs`` after a warm call; the
    JAX probe's keys plus the device's busy time per call from a trace."""
    fn = variant_fn(layout, variant)
    it = iter(xs * 2)  # the warm call, then one call per x
    dev = layout.device
    avg_ms = time_ms(dev, lambda: fn(next(it)), len(xs))
    W, C, n_chunks = layout.window, layout.chunk, layout.n_chunks
    bytes_pass = n_chunks * (C * 12 + W * 4 + W * 4)  # edges + x + y blocks
    return {
        "probe": "v5_floor", "variant": variant, "scale": scale,
        "window": W, "chunk": C, "n_chunks": n_chunks,
        "avg_ms": avg_ms,
        "device_ms": device_ms(dev, lambda: fn(xs[0]), len(xs)),
        "gedges_per_s": n_edges / avg_ms / 1e6,
        "gbps_blocks": bytes_pass / (avg_ms / 1e3) / 1e9,
        "device": device_label(dev),
    }


def split(layout, rows: dict) -> dict:
    """Where the full pass's time goes, from the three variants' lines
    (``rows[variant]``): stream, gather and scatter in ms (wall, and device
    where traced), beside the card's bound for the real slots."""
    from gunrock_tpu_torch.utils.roofline import bound_ms

    out = {"probe": "v5_floor_split", "device": device_label(layout.device)}
    for key in ("avg_ms", "device_ms"):
        t = {v: rows[v][key] for v in VARIANTS}
        if any(isinstance(x, str) for x in t.values()):
            continue
        sfx = "" if key == "avg_ms" else "_device"
        out[f"stream_ms{sfx}"] = t["dma"]
        out[f"gather_ms{sfx}"] = t["gather"] - t["dma"]
        out[f"scatter_ms{sfx}"] = t["full"] - t["gather"]
    if layout.device.type == "cuda":
        n_real = int((layout.row_local != layout.window).sum())
        n_bytes = 12 * n_real + 4 * layout.n_vertices + 4 * layout.n_vertices
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, 2 * n_real,
                                                    device=layout.device)
        out["real_slots"] = n_real
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gunrock_tpu_torch.probes.v5_floor")
    p.add_argument("variant", nargs="?", default="all",
                   choices=(*VARIANTS, "all"))
    p.add_argument("--scale", type=int, default=18)
    p.add_argument("--window", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--num_runs", type=int, default=20)
    p.add_argument("--device", default="cuda")
    ns = p.parse_args(argv)
    from gunrock_tpu_torch.ops.kernels.layout import pull_layout

    graph = probe_graph(ns.scale, ns.device)
    layout = pull_layout(graph, window=ns.window, chunk=ns.chunk)
    xs = probe_inputs(layout, ns.num_runs)
    variants = VARIANTS if ns.variant == "all" else (ns.variant,)
    rows = {}
    for v in variants:
        rows[v] = run_variant(layout, graph.n_edges, v, xs, ns.scale)
        print(json.dumps(rows[v]), flush=True)
    if ns.variant == "all":
        print(json.dumps(split(layout, rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
