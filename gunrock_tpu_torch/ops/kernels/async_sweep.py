"""Gauss-Seidel block sweeps: the async solver's whole loop in one launch.

Port of ``gunrock_tpu/experimental/async_sweep.py::_sweep_kernel`` (min-
plus sweeps: SSSP, and BFS on unit weights) and ``::_pr_gs_kernel``
(PageRank sweeps), which the JAX package compiles into one
``lax.while_loop`` each (XLA, no Pallas), so that the host reads nothing
until the search ends.

Both take a block plan: ``v_starts`` int32[n_blocks + 1] (contiguous
vertex blocks) and ``e_starts`` int32[n_blocks] (each block's first CSC
slot; its in-edges are ``[e_starts[b], e_starts[b + 1])``, E for the
last), from ``experimental/async_sweep.py::_block_plan``.

CUDA source: ``csrc/async_sweep.cu``: one cooperative launch a search, the
grid walking the sweeps, blocks and passes together, one grid barrier a
block pass (min-plus defers each pass's commit to the next; PageRank sums
in warp tiles of 32 CSC slots and stages its new ranks by pass parity);
the counts stay on the card until the wrapper reads them, once, at the
end, with the grid barriers the kernel passed and its grid's shape
(``LAST_RUN``). The plain versions below are Python loops that mirror the JAX code
line for line, with one host read a block pass; a wrapper given CPU
tensors runs them.

Spans (``utils/profiler.py``): ``kernel.gs_sweep_min`` around that
wrapper, with ``block_passes`` and ``grid_barriers`` from ``LAST_RUN`` on
the card, and ``async.sync`` around the one read of the counts.
"""

from __future__ import annotations

import ctypes

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.utils.profiler import annotate, host_read

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "gr_gs_sweep_min": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                        _I, _P],
    "gr_gs_sweep_pr": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _L, _F, _F, _F, _I, _P],
}
_NOT_SUPPORTED = 801  # cudaErrorNotSupported: no cooperative launch
# what each kernel's last launch counted on the card, read with its counts
# in the search's one device-to-host read: {"gs_sweep_min" | "gs_sweep_pr":
# {"block_passes", "grid_barriers", "ctas", "cluster_ctas"}}
LAST_RUN: dict = {}


def _check_plan(csc_rows, csc_values, csc_dst, v_starts, e_starts, V: int):
    dev = csc_rows.device
    E = csc_rows.shape[0]
    n_blocks = v_starts.shape[0] - 1
    if n_blocks < 1:
        raise ValueError("the block plan needs at least one block")
    _build.check_tensor(csc_rows, "csc_rows", torch.int32, (E,), dev)
    _build.check_tensor(csc_values, "csc_values", torch.float32, (E,), dev)
    _build.check_tensor(csc_dst, "csc_dst", torch.int32, (E,), dev)
    _build.check_tensor(v_starts, "v_starts", torch.int32, (n_blocks + 1,), dev)
    _build.check_tensor(e_starts, "e_starts", torch.int32, (n_blocks,), dev)
    return dev, E, n_blocks


def _launched(err: int, what: str, out) -> tuple:
    """Checks the launch, counts it, and reads ``out`` (the search's one
    device-to-host read): returns (sweeps, block passes)."""
    if err == _NOT_SUPPORTED:
        raise RuntimeError(f"{what}: the device has no cooperative launch "
                           "(cudaDevAttrCooperativeLaunch)")
    _build.check(err, what)
    _build.LAUNCHES[what] += 1
    sweeps, passes, barriers, ctas, cluster = host_read("async", out)
    LAST_RUN[what] = {"block_passes": passes, "grid_barriers": barriers,
                      "ctas": ctas, "cluster_ctas": cluster}
    return sweeps, passes


def gs_sweep_min(csc_rows, csc_values, csc_dst, v_starts, e_starts,
                 dist0, max_sweeps: int):
    """Min-plus Gauss-Seidel sweeps from ``dist0`` f32[V]. Returns
    ``(dist f32[V], sweeps, block_passes)``: a sweep walks every block
    once (forward on even sweeps, backward on odd ones), and each block
    repeats passes to its local fixed point; ``block_passes`` counts them
    all."""
    with annotate("kernel.gs_sweep_min") as span:
        V = dist0.shape[0]
        dev, E, n_blocks = _check_plan(csc_rows, csc_values, csc_dst,
                                       v_starts, e_starts, V)
        _build.check_tensor(dist0, "dist0", torch.float32, (V,), dev)
        if dev.type == "cpu":
            return gs_sweep_min_plain(csc_rows, csc_values, csc_dst,
                                      v_starts, e_starts, dist0, max_sweeps)
        if dev.type != "cuda":
            raise ValueError(f"no gs_sweep_min kernel for device {dev}")
        max_grid = _build.sm_count(dev)
        dist = torch.empty(V, dtype=torch.float32, device=dev)
        # the barrier's slots and counters, then R[0..2]
        scratch = torch.empty(4 * max_grid + 4 + 3 * V, dtype=torch.float32,
                              device=dev)
        out = torch.empty(5, dtype=torch.int64, device=dev)
        lib = _build.load("async_sweep", _SIGNATURES)
        err = lib.gr_gs_sweep_min(
            _build.ptr(csc_rows), _build.ptr(csc_values), _build.ptr(csc_dst),
            _build.ptr(v_starts), _build.ptr(e_starts), _build.ptr(dist0),
            _build.ptr(dist), _build.ptr(scratch), _build.ptr(out), V, E,
            n_blocks, int(max_sweeps), max_grid, _build.stream(dev),
        )
        sweeps, passes = _launched(err, "gs_sweep_min", out)
        last = LAST_RUN["gs_sweep_min"]
        span.set(block_passes=last["block_passes"],
                 grid_barriers=last["grid_barriers"])
        return dist, sweeps, passes


def gs_sweep_min_plain(csc_rows, csc_values, csc_dst, v_starts, e_starts,
                       dist0, max_sweeps: int):
    """Plain PyTorch version of :func:`gs_sweep_min`."""
    E = csc_rows.shape[0]
    vs = v_starts.tolist()
    es = e_starts.tolist() + [E]
    n_blocks = len(vs) - 1
    inf = float("inf")
    d = dist0.clone()
    sweeps, passes, changed = 0, 0, True
    while changed and sweeps < max_sweeps:
        old = d.clone()
        order = range(n_blocks) if sweeps % 2 == 0 else range(n_blocks - 1, -1, -1)
        for b in order:
            v0, v1, e0, e1 = vs[b], vs[b + 1], es[b], es[b + 1]
            src = csc_rows[e0:e1].long()
            w = csc_values[e0:e1]
            loc = (csc_dst[e0:e1] - v0).long()
            block_changed = True
            while block_changed:
                cand = d[src] + w
                relaxed = torch.full((v1 - v0,), inf, dtype=d.dtype,
                                     device=d.device).scatter_reduce_(
                    0, loc, cand, "amin", include_self=True)
                cur = d[v0:v1]
                upd = torch.minimum(cur, relaxed)
                block_changed = bool((upd < cur).any())
                d[v0:v1] = upd
                passes += 1
        changed = bool((d < old).any())
        sweeps += 1
    return d, sweeps, passes


def _zero_in(offsets, v_starts):
    """int32[n_blocks]: each block's vertices without in-edges, from the
    csc ``offsets`` (device ops only, no host read)."""
    zero = torch.zeros(offsets.shape[0], dtype=torch.int32,
                       device=offsets.device)
    zero[1:] = torch.cumsum(offsets[1:] == offsets[:-1], 0)
    vs = v_starts.long()
    return (zero[vs[1:]] - zero[vs[:-1]]).to(torch.int32)


def _n_tiles(E: int) -> int:
    """Warp tiles of 32 CSC slots, aligned to 32, that any block of an
    E-edge plan can span (csrc/async_sweep.cu's tagged partial slots)."""
    return (E + 62) // 32 + 1


def gs_sweep_pr(csc_rows, csc_values, csc_dst, v_starts, e_starts, iweights,
                dangling, p0, alpha: float, tol: float, max_sweeps: int):
    """Gauss-Seidel PageRank sweeps from ``p0`` f32[V]; ``csc_values`` has
    ``alpha`` folded in, ``iweights`` is 1 / out-weight (0 where
    ``dangling``). Returns ``(p f32[V], sweeps)``. Sums are taken in a
    fixed order: two runs give the same bits."""
    V = p0.shape[0]
    dev, E, n_blocks = _check_plan(csc_rows, csc_values, csc_dst, v_starts,
                                   e_starts, V)
    _build.check_tensor(iweights, "iweights", torch.float32, (V,), dev)
    _build.check_tensor(dangling, "dangling", torch.bool, (V,), dev)
    _build.check_tensor(p0, "p0", torch.float32, (V,), dev)
    if dev.type == "cpu":
        return gs_sweep_pr_plain(csc_rows, csc_values, csc_dst, v_starts,
                                 e_starts, iweights, dangling, p0, alpha,
                                 tol, max_sweeps)
    if dev.type != "cuda":
        raise ValueError(f"no gs_sweep_pr kernel for device {dev}")
    offsets = torch.searchsorted(
        csc_dst, torch.arange(V + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    zero_in = _zero_in(offsets, v_starts)
    tiles = _n_tiles(E)
    max_grid = _build.sm_count(dev)
    p = torch.empty(V, dtype=torch.float32, device=dev)
    # tagged partials (u64), the barrier's slots and counters, then p * iw
    # and the four staging vectors
    scratch = torch.empty(16 * tiles + 16 * max_grid + 16 + 20 * V,
                          dtype=torch.uint8, device=dev)
    out = torch.empty(5, dtype=torch.int64, device=dev)
    lib = _build.load("async_sweep", _SIGNATURES)
    err = lib.gr_gs_sweep_pr(
        _build.ptr(csc_rows), _build.ptr(csc_values), _build.ptr(csc_dst),
        _build.ptr(offsets), _build.ptr(v_starts), _build.ptr(e_starts),
        _build.ptr(zero_in), _build.ptr(iweights), _build.ptr(dangling),
        _build.ptr(p0), _build.ptr(p), _build.ptr(scratch), _build.ptr(out),
        V, E, n_blocks, tiles, int(max_sweeps), float(alpha), float(1.0 - alpha), float(tol),
        max_grid, _build.stream(dev),
    )
    sweeps, _ = _launched(err, "gs_sweep_pr", out)
    return p, sweeps


def gs_sweep_pr_plain(csc_rows, csc_values, csc_dst, v_starts, e_starts,
                      iweights, dangling, p0, alpha: float, tol: float,
                      max_sweeps: int):
    """Plain PyTorch version of :func:`gs_sweep_pr`."""
    V = p0.shape[0]
    E = csc_rows.shape[0]
    vs = v_starts.tolist()
    es = e_starts.tolist() + [E]
    n_blocks = len(vs) - 1
    p = p0.clone()
    dsum = torch.where(dangling, alpha * p, 0.0).sum()
    sweeps, err = 0, float("inf")
    while err >= tol and sweeps < max_sweeps:
        order = range(n_blocks) if sweeps % 2 == 0 else range(n_blocks - 1, -1, -1)
        err_t = torch.zeros((), dtype=torch.float32, device=p.device)
        for b in order:
            v0, v1, e0, e1 = vs[b], vs[b + 1], es[b], es[b + 1]
            if v1 == v0:
                continue
            src = csc_rows[e0:e1].long()
            contrib = p[src] * iweights[src] * csc_values[e0:e1]
            summed = torch.zeros(v1 - v0, dtype=p.dtype, device=p.device
                                 ).index_add_(0, (csc_dst[e0:e1] - v0).long(),
                                              contrib)
            base = (1.0 - alpha + dsum) / V
            cur = p[v0:v1]
            new = base + summed
            dsum = dsum + alpha * torch.where(dangling[v0:v1], new - cur,
                                              0.0).sum()
            err_t = torch.maximum(err_t, (new - cur).abs().max())
            p[v0:v1] = new
        err = float(err_t)
        sweeps += 1
    return p, sweeps
