"""Bytes-moved roofline model, against the card's published peaks.

Counterpart of ``gunrock_tpu/utils/roofline.py``. ``model_bytes`` is the
JAX package's arithmetic unchanged: 12 B per edge slot touched (int32 row,
int32 col, f32 value) plus 8 B per vertex-vector pass (f32 read + f32
write), with ``edges_visited`` the workload counter the run already
reports (``framework.benchmark``). It undercounts (no metadata re-reads,
no padding), so an achieved share is a lower-is-honest bound.

Where the JAX package divides by the TPU's measured ``STREAM_GBPS``, the
port divides by the card's published memory rate from
``device.properties``, and says which card and power limit. A CPU run, or
a card with no published peaks, gets no device share. XLA's cost model
(``cost_analysis_bytes``) has no PyTorch counterpart and is left out.

``bound_ms`` is the least time the card could take for a function: the
larger of its bytes over the memory rate and its f32 operations over the
f32 rate.
"""

from __future__ import annotations

from gunrock_tpu_torch.device.properties import get_device_properties

BYTES_PER_EDGE = 12  # int32 row + int32 col + f32 value
BYTES_PER_VERTEX_PASS = 8  # f32 read + f32 write


def model_bytes(algo: str, n_vertices: int, n_edges: int,
                edges_visited: int, extra: dict) -> int:
    """Lower-bound device-memory bytes for one timed run of ``algo``."""
    V, E = n_vertices, n_edges
    rounds = int(
        extra.get("search_depth")
        or extra.get("iterations")
        or extra.get("rounds")
        or 1
    )
    base = edges_visited * BYTES_PER_EDGE
    if algo in ("bfs", "sssp"):
        # per level: frontier mask + distance vector touched
        return base + (rounds + 1) * V * BYTES_PER_VERTEX_PASS
    if algo in ("pr", "hits", "geo"):
        # dense power iterations: edges_visited already counts E*rounds
        return base + rounds * V * BYTES_PER_VERTEX_PASS
    if algo == "spmv":
        return base + V * BYTES_PER_VERTEX_PASS
    if algo == "bc":
        # forward + backward pass over E, sigma/delta/labels vectors
        return 2 * E * BYTES_PER_EDGE + 3 * V * BYTES_PER_VERTEX_PASS
    if algo in ("color", "kcore", "mst", "ppr", "tc", "spgemm"):
        # edges_visited approximates the per-algo pass structure already
        return base + V * BYTES_PER_VERTEX_PASS
    return base


def roofline(algo: str, n_vertices: int, n_edges: int, edges_visited: int,
             avg_ms: float, extra: dict, device="cuda") -> dict:
    """JSON-ready roofline columns for a run of ``algo`` on ``device``:
    ``model_mb``, ``gbps``, and on a card with published peaks
    ``pct_peak_bw``, beside the device's name and power limit."""
    if avg_ms <= 0:
        return {}
    props = get_device_properties(device)
    b = model_bytes(algo, n_vertices, n_edges, edges_visited, extra)
    gbps = b / (avg_ms * 1e-3) / 1e9
    out = {"model_mb": b / 1e6, "gbps": gbps, "device": props.name,
           "power_limit": props.power_limit}
    if props.peak_bytes_per_s:
        out["pct_peak_bw"] = 100.0 * gbps * 1e9 / props.peak_bytes_per_s
    return out


def bound_ms(n_bytes: float, n_ops: float = 0.0,
             device="cuda") -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time ``device`` could take
    to move ``n_bytes`` and do ``n_ops`` f32 operations, and which of the
    two sets it. Raises where the device has no published peaks."""
    props = get_device_properties(device)
    if not (props.peak_bytes_per_s and props.peak_f32_per_s):
        raise ValueError(f"no published peaks for {props.name}: no bound")
    t_bytes = n_bytes / props.peak_bytes_per_s * 1e3
    t_ops = n_ops / props.peak_f32_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
