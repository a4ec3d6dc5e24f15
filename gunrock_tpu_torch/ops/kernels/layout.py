"""Bucketed edge layout, the data the port's kernels walk (built once on
the host).

Counterpart of ``gunrock_tpu/ops/pallas/layout.py``, with the same arrays
built by the same numpy code, so a parity test can feed one layout to both
packages. Edges are grouped into (row window, col window) buckets of size
W and cut into chunks of C slots; each chunk touches one x window and one
y window. Padding slots carry ``row_local == W``, ``col_local == 0`` and
``pad_value``.

What the port leaves out: the TPU's SMEM chunk budget, W doubling and
paged metadata (``layout.py:194-266``), and the ``rb*65536+cb`` packing
limit (``layout.py:95-103``). The port keeps ``chunk_rb``/``chunk_cb`` as
two int32 tensors and builds at W=2048/C=256, or at W=4096/C=1024 where
:func:`dense_window_chunk` picks it for a dense-only algorithm.

What the port adds: the span table of the semiring pull
(``csrc/semiring.cu``). Chunks are sorted by row block, so each row
block's chunks are one contiguous range; :func:`span_table` cuts each
range into spans of at most P chunks (``span_chunks``: about
``SPAN_SLOTS`` slots each), and one block of the pull reduces one span
into its row window in shared memory. It is computed from ``chunk_rb``
whenever a layout is made, so a layout carried over from the JAX package's
arrays has it too; it is not one of ``DATA_FIELDS``.

And a column span table beside it, for the kernels that scatter by column
(the auth side of the fused HITS pass, ``csrc/hits_fused.cu``):
``chunk_by_cb`` lists the chunk ids in column-block order (a stable
argsort of ``chunk_cb``), and the same :func:`span_table` over
``chunk_cb[chunk_by_cb]`` cuts each column block's run of that list into
spans (``col_span_first_chunk`` indexes ``chunk_by_cb``;
``cb_first_span`` names each column block's spans).

Spans (``utils/profiler.py``): the build of a graph's cached layout is
``layout.pull`` (``layout.push``), with its kind, window and chunk, and
the host sort and bucketing of :func:`build_bucketed_layout` inside it is
``layout.sort``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gunrock_tpu_torch.device import DEFAULT, resolve
from gunrock_tpu_torch.utils.profiler import annotate

DATA_FIELDS = ("row_local", "col_local", "values", "chunk_rb", "chunk_cb",
               "rb_occupied", "src_bits", "dst_bits")
META_FIELDS = ("window", "chunk", "n_chunks", "n_row_blocks", "n_col_blocks",
               "n_vertices")
_DTYPES = {"row_local": np.int32, "col_local": np.int32,
           "values": np.float32, "chunk_rb": np.int32, "chunk_cb": np.int32,
           "rb_occupied": np.bool_}

WINDOW, CHUNK = 2048, 256
SPAN_SLOTS = 8192  # slots one block of the semiring pull aims to reduce


def span_chunks(chunk: int) -> int:
    """P, the most chunks of one span: ``SPAN_SLOTS // chunk``, at least 1
    (32 at C=256, 8 at C=1024)."""
    return max(1, SPAN_SLOTS // chunk)


def span_table(chunk_rb, n_row_blocks: int, max_chunks: int):
    """(span_first_chunk int32[n_spans + 1], rb_first_span
    int32[n_row_blocks + 1]) for chunks sorted by row block: each row
    block's chunk range is cut into ceil(n / max_chunks) spans of as near
    equal length as can be, so a span lies in one row block and holds at
    most ``max_chunks`` chunks. Span s covers chunks
    [span_first_chunk[s], span_first_chunk[s + 1]); row block rb owns
    spans [rb_first_span[rb], rb_first_span[rb + 1]), none where no chunk
    reaches it."""
    rb = np.asarray(chunk_rb).astype(np.int64)
    if max_chunks < 1:
        raise ValueError(f"max_chunks must be >= 1, got {max_chunks}")
    if rb.size and (np.any(np.diff(rb) < 0) or rb[0] < 0
                    or rb[-1] >= n_row_blocks):
        raise ValueError("chunk_rb must be sorted and within the row blocks")
    counts = np.bincount(rb, minlength=n_row_blocks)
    rb_start = np.zeros(n_row_blocks + 1, np.int64)
    np.cumsum(counts, out=rb_start[1:])
    n_span = -(-counts // max_chunks)
    rb_first_span = np.zeros(n_row_blocks + 1, np.int64)
    np.cumsum(n_span, out=rb_first_span[1:])
    span_rb = np.repeat(np.arange(n_row_blocks), n_span)
    k = np.arange(span_rb.size) - rb_first_span[span_rb]
    # span k of n over a block's c chunks starts at chunk floor(k * c / n)
    first = rb_start[span_rb] + k * counts[span_rb] // n_span[span_rb]
    span_first_chunk = np.append(first, rb.size)
    return span_first_chunk.astype(np.int32), rb_first_span.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BucketedEdges:
    row_local: torch.Tensor  # int32[n_chunks * chunk] — row % W (W if pad)
    col_local: torch.Tensor  # int32[n_chunks * chunk] — col % W (0 if pad)
    values: torch.Tensor  # float32[n_chunks * chunk] — pad_value for padding
    chunk_rb: torch.Tensor  # int32[n_chunks] — row block of each chunk
    chunk_cb: torch.Tensor  # int32[n_chunks] — col block of each chunk
    rb_occupied: torch.Tensor  # bool[n_row_blocks] — touched by >= 1 chunk
    # bit b of src_bits[ch] is set iff chunk ch has a real edge whose source
    # lies in sub-block b (W/32 vertices) of its col window; dst_bits the
    # same for rows. uint32 words held as int32 (same bits).
    src_bits: torch.Tensor  # int32[n_chunks]
    dst_bits: torch.Tensor  # int32[n_chunks]
    window: int
    chunk: int
    n_chunks: int
    n_row_blocks: int
    n_col_blocks: int
    n_vertices: int
    # the span table (span_table): int32[n_spans + 1], int32[n_row_blocks + 1]
    span_first_chunk: torch.Tensor
    rb_first_span: torch.Tensor
    # the column span table: int32[n_chunks] (chunk ids by column block),
    # int32[n_col_spans + 1] (positions in chunk_by_cb),
    # int32[n_col_blocks + 1]
    chunk_by_cb: torch.Tensor
    col_span_first_chunk: torch.Tensor
    cb_first_span: torch.Tensor
    # the most chunks of one row span (0 without chunks)
    max_span_chunks: int

    @classmethod
    def from_arrays(cls, arrays: dict, window: int, chunk: int, n_chunks: int,
                    n_row_blocks: int, n_col_blocks: int, n_vertices: int,
                    device=DEFAULT) -> "BucketedEdges":
        """Layout from the eight named numpy arrays (``DATA_FIELDS``) and
        the six meta fields, with its row and column span tables at P =
        ``span_chunks``. Bit words may come as uint32 or int32."""
        dev = resolve(device)
        tensors = {}
        for name in DATA_FIELDS:
            a = np.asarray(arrays[name])  # astype below copies: writable
            if name in ("src_bits", "dst_bits"):
                a = a.astype(np.uint32).view(np.int32)
            else:
                a = a.astype(_DTYPES[name])
            tensors[name] = torch.from_numpy(a).to(dev)
        spans = _span_tables(arrays["chunk_rb"], arrays["chunk_cb"],
                             int(n_row_blocks), int(n_col_blocks),
                             span_chunks(int(chunk)), dev)
        return cls(**tensors, window=int(window), chunk=int(chunk),
                   n_chunks=int(n_chunks), n_row_blocks=int(n_row_blocks),
                   n_col_blocks=int(n_col_blocks), n_vertices=int(n_vertices),
                   **spans)

    def with_span_chunks(self, max_chunks: int) -> "BucketedEdges":
        """The same layout with both span tables cut at P = ``max_chunks``
        (to measure the span kernels at another P)."""
        return dataclasses.replace(self, **_span_tables(
            self.chunk_rb.cpu().numpy(), self.chunk_cb.cpu().numpy(),
            self.n_row_blocks, self.n_col_blocks, max_chunks, self.device))

    @property
    def device(self) -> torch.device:
        return self.row_local.device

    @property
    def n_spans(self) -> int:
        return self.span_first_chunk.numel() - 1

    @property
    def n_col_spans(self) -> int:
        return self.col_span_first_chunk.numel() - 1


def _span_tables(chunk_rb, chunk_cb, n_row_blocks: int, n_col_blocks: int,
                 max_chunks: int, device) -> dict:
    """The row and column span tables at P = ``max_chunks``, as the
    layout's fields on ``device``."""
    cb = np.asarray(chunk_cb)
    by_cb = np.argsort(cb, kind="stable").astype(np.int32)
    rows = span_table(chunk_rb, n_row_blocks, max_chunks)
    cols = span_table(cb[by_cb], n_col_blocks, max_chunks)
    names = ("span_first_chunk", "rb_first_span", "chunk_by_cb",
             "col_span_first_chunk", "cb_first_span")
    out = {k: torch.from_numpy(a).to(device)
           for k, a in zip(names, (*rows, by_cb, *cols))}
    out["max_span_chunks"] = int(np.diff(rows[0]).max(initial=0))
    return out


def _pack_subblock_bits(chunk_ids, local, window: int, n_chunks: int):
    """uint32[n_chunks]: bit b set iff some edge of the chunk has its
    window-local index in sub-block b (sub-block = window/32 vertices)."""
    if window < 32 or window % 32:
        raise ValueError(
            f"sub-block bit packing needs window to be a multiple of 32 "
            f"and >= 32, got {window}"
        )
    sub = window // 32
    pair = chunk_ids.astype(np.int64) * 32 + local.astype(np.int64) // sub
    occ = np.bincount(pair, minlength=n_chunks * 32).reshape(n_chunks, 32) > 0
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (occ * weights).sum(axis=1).astype(np.uint32)


def build_bucketed_layout(rows, cols, values, n_vertices: int,
                          window: int = 512, chunk: int = 1024,
                          pad_value: float = 0.0,
                          device=DEFAULT, return_slots: bool = False):
    """Bucket (row, col, value) edges into the chunked window layout on
    ``device``, building it with numpy on the host. ``pad_value`` fills
    padding slots' values. With ``return_slots`` returns (layout,
    int64[n_edges] the slot each input edge went to), for a caller that
    keeps per-edge data of another type beside the layout."""
    device = resolve(device)
    with annotate("layout.sort"):
        data, dest, order, n_chunks = _bucket(rows, cols, values, n_vertices,
                                              window, chunk, pad_value)
    n_rb = -(-n_vertices // window)
    layout = BucketedEdges.from_arrays(
        data, window=window, chunk=chunk, n_chunks=n_chunks,
        n_row_blocks=n_rb, n_col_blocks=n_rb, n_vertices=n_vertices,
        device=device)
    if not return_slots:
        return layout
    slots = np.empty(dest.size, dtype=np.int64)
    slots[order] = dest
    return layout, slots


def _bucket(rows, cols, values, n_vertices: int, window: int, chunk: int,
            pad_value: float):
    """The host part of :func:`build_bucketed_layout`: (the eight arrays
    of ``DATA_FIELDS``, each edge's slot in sorted order, the sort order,
    the chunk count)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values, dtype=np.float32)
    n_rb = -(-n_vertices // window)
    n_cb = -(-n_vertices // window)
    rb = rows // window
    cb = cols // window
    order = np.lexsort((cb, rb))  # sort edges by (rb, cb); stable
    rows, cols, values, rb, cb = (
        rows[order], cols[order], values[order], rb[order], cb[order]
    )
    bucket = rb * n_cb + cb
    # edge j with within-bucket rank r goes to slot
    # (chunk_offset[bucket] + r // chunk) * chunk + r % chunk
    uniq, inverse, counts = np.unique(bucket, return_inverse=True,
                                      return_counts=True)
    starts = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(rows.size, dtype=np.int64) - starts[inverse]
    chunks_per_bucket = -(-counts // chunk)
    chunk_off = np.zeros_like(chunks_per_bucket)
    np.cumsum(chunks_per_bucket[:-1], out=chunk_off[1:])
    n_chunks = int(chunks_per_bucket.sum())
    dest = (chunk_off[inverse] + rank // chunk) * chunk + rank % chunk
    E_out = n_chunks * chunk
    row_local = np.full(E_out, window, dtype=np.int32)  # padding sentinel
    col_local = np.zeros(E_out, dtype=np.int32)
    vals_out = np.full(E_out, pad_value, dtype=np.float32)
    row_local[dest] = (rows - rb * window).astype(np.int32)
    col_local[dest] = (cols - cb * window).astype(np.int32)
    vals_out[dest] = values
    rb_occupied = np.zeros(n_rb, dtype=bool)
    rb_occupied[(uniq // n_cb).astype(np.int64)] = True
    data = {
        "row_local": row_local,
        "col_local": col_local,
        "values": vals_out,
        "chunk_rb": np.repeat((uniq // n_cb).astype(np.int32), chunks_per_bucket),
        "chunk_cb": np.repeat((uniq % n_cb).astype(np.int32), chunks_per_bucket),
        "rb_occupied": rb_occupied,
        "src_bits": _pack_subblock_bits(dest // chunk, cols - cb * window,
                                        window, n_chunks),
        "dst_bits": _pack_subblock_bits(dest // chunk, rows - rb * window,
                                        window, n_chunks),
    }
    return data, dest, order, n_chunks


def build_auto_layout(rows, cols, values, n_vertices: int,
                      pad_value: float = 0.0,
                      device=DEFAULT) -> BucketedEdges:
    """The layout at W=2048/C=256. (The JAX package grows W past the TPU's
    scalar-memory chunk budget; the port has no such budget.)"""
    return build_bucketed_layout(rows, cols, values, n_vertices,
                                 window=WINDOW, chunk=CHUNK,
                                 pad_value=pad_value, device=device)


def slot_indices(layout: BucketedEdges, ch_act: torch.Tensor | None = None):
    """(row, col, slot): global row and column and the slot index of every
    real (non-padding) slot, of the chunks in ``ch_act`` (all chunks when
    None). The plain kernel versions walk the layout through these."""
    W, C = layout.window, layout.chunk
    slot_chunk = torch.arange(layout.n_chunks * C, device=layout.device) // C
    real = layout.row_local != W
    if ch_act is not None:
        real &= ch_act[slot_chunk]
    slot = torch.nonzero(real).flatten()
    ch = slot_chunk[slot]
    row = layout.chunk_rb[ch].long() * W + layout.row_local[slot]
    col = layout.chunk_cb[ch].long() * W + layout.col_local[slot]
    return row, col, slot


def _graph_layout(graph, kind: str, window, chunk, pad_value, unit):
    window = WINDOW if window is None else window
    chunk = CHUNK if chunk is None else chunk
    # the defaults spelled out or left None: one cache entry
    key = (kind, window, chunk, float(pad_value), unit)
    if key not in graph.layouts:
        with annotate(f"layout.{kind}", kind="unit" if unit else "valued",
                      window=window, chunk=chunk):
            h = graph.host
            # push: rows = sources, cols = destinations; pull: the transpose
            rows, cols = h["edge_src"], h["col_indices"]
            if kind == "pull":
                rows, cols = cols, rows
            vals = np.ones(graph.n_edges, np.float32) if unit else h["values"]
            graph.layouts[key] = build_bucketed_layout(
                rows, cols, vals, graph.n_vertices,
                window=window, chunk=chunk, pad_value=pad_value,
                device=graph.device,
            )
    return graph.layouts[key]


def push_layout(graph, window: int | None = None, chunk: int | None = None,
                pad_value: float = 0.0, unit: bool = False) -> BucketedEdges:
    """Layout of the CSR edge set (rows=src, cols=dst): push advance,
    y[src] = reduce over out-edges of f(x[dst], w). Cached on the graph."""
    return _graph_layout(graph, "push", window, chunk, pad_value, unit)


def pull_layout(graph, window: int | None = None, chunk: int | None = None,
                pad_value: float = 0.0, unit: bool = False) -> BucketedEdges:
    """Layout of the transposed edge set (rows=dst, cols=src): pull
    advance, y[dst] = reduce over in-edges of f(x[src], w). ``unit=True``
    sets every weight to 1.0 (BFS reachability). Cached on the graph."""
    return _graph_layout(graph, "pull", window, chunk, pad_value, unit)


def dense_window_chunk(n_vertices: int) -> tuple[int, int] | None:
    """(window, chunk) for the dense-only algorithms, PageRank and HITS
    (no frontier-sparse passes): fewer, bigger chunks, W=4096/C=1024, for
    2^16 <= V <= 2^20; None (the default W=2048/C=256) otherwise. The JAX
    package's pick (``layout.py:297-309``); coarser windows skip fewer
    chunks in a sparse pass, so traversals keep the default."""
    if n_vertices < (1 << 16) or n_vertices > (1 << 20):
        return None
    return 4096, 1024


def layout_for_graph(graph, window: int | None = None,
                     chunk: int | None = None) -> BucketedEdges:
    """The graph's CSR edges with their weights (rows = sources, cols =
    destinations): the JAX package's name for the valued
    :func:`push_layout`, whose cache entry it shares."""
    return push_layout(graph, window=window, chunk=chunk)
