"""Bit-parallel multi-source BFS (Then et al., "The More the Merrier:
Efficient Multi-Source Graph Traversal", VLDB 2015): K searches as bits,
search k being bit ``k % 32`` of word ``k // 32`` of a vertex's row of
``n_words(K)`` int32 words (the bit patterns of uint32 words: torch's CPU
build has no ``bitwise_not`` or scatter reductions for ``torch.uint32``).

:class:`MsbfsState` holds the searches: ``front`` (the level's frontier),
``next`` and ``seen``, words [V, n_words(K)]; ``dist``, int32 [V, K];
``aux``, three slots of the live words (the OR of a frontier: the searches
it holds) and the frontier bitmap (bit ``v % 32`` of word ``v // 32``:
whether v's frontier row is not zero); and ``counts``, int64 [3].
:func:`msbfs_start` writes the sources into it; :func:`msbfs_pull` runs one
level L: for each vertex v and word w with unseen live bits ``need =
~seen[v, w] & mask(w) & live[w]`` (live from aux slot L % 3), the OR of
``front[u, w]`` over v's in-neighbours u (its CSC run) gives ``next[v, w]
= acc & need``, ``seen[v, w] |= next[v, w]`` and ``dist[v, k] = L + 1`` for
each bit k of it; every other word of ``next`` is 0. A search with no
frontier vertex gains nothing, so leaving it out of ``need`` changes no
result. The next frontier's live words and bitmap go to aux slot (L + 1) %
3, and slot (L + 2) % 3 is zeroed; ``front`` and ``next`` then swap.
Counters: ``counts[(L + 1) % 2]`` gets the vertices whose ``next`` row is
not zero and ``counts[L % 2]`` is zeroed (the host read it before the
level); ``counts[2]`` adds the slots the level needed: for each scanned
(v, w), v's run up to and including the slot at which the OR covers
``need``, or the whole run where it never does. The start writes
``counts`` as [distinct source vertices, 0, 0], so the read before level L
finds the frontier's size at ``counts[L % 2]`` and the running slot total
at ``counts[2]``.

On the CPU both run their plain versions; on the card each is one launch
of ``csrc/msbfs.cu``, the level a scan of each vertex's CSC run by a lane,
a warp or a block by its length that stops once the OR covers ``need``,
gathering only the sources on the frontier bitmap. The kernel replaces no
TPU kernel: the JAX package's ``msbfs_kernel`` calls B4, the bucketed SpMM
(``spmm.py``), which stays.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.utils.limits import UNREACHED
from gunrock_tpu_torch.utils.profiler import annotate

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gr_msbfs_start": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "gr_msbfs_pull": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
}


def n_words(n_searches: int) -> int:
    """Words a vertex's row holds for ``n_searches`` searches (at least 1)."""
    return max(1, -(-n_searches // 32))


@dataclasses.dataclass
class MsbfsState:
    """K searches on a graph of V vertices (see the module docstring)."""

    dist: torch.Tensor    # int32 [V, K], UNREACHED where unreached
    front: torch.Tensor   # int32 [V, n_words(K)]
    next: torch.Tensor    # int32 [V, n_words(K)]
    seen: torch.Tensor    # int32 [V, n_words(K)]
    aux: torch.Tensor     # int32 [3, n_words(K) + ceil(V / 32)]
    counts: torch.Tensor  # int64 [3]

    @classmethod
    def empty(cls, n_vertices: int, n_searches: int, device):
        """Distances UNREACHED, words zero (one fill, one memset)."""
        V, nw = n_vertices, n_words(n_searches)
        dist = torch.full((V, n_searches), UNREACHED, dtype=torch.int32,
                          device=device)
        words = torch.zeros(3 * V * nw + 3 * (nw + -(-V // 32)),
                            dtype=torch.int32, device=device)
        front, nxt, seen = words[:3 * V * nw].view(3, V, nw)
        aux = words[3 * V * nw:].view(3, -1)
        return cls(dist, front, nxt, seen, aux,
                   torch.empty(3, dtype=torch.int64, device=device))

    def tensors(self) -> dict:
        """{field: tensor}, the tensors themselves."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def check(self, graph) -> None:
        V, K = graph.n_vertices, self.dist.shape[1]
        nw, dev = n_words(K), graph.device
        _build.check_tensor(self.dist, "dist", torch.int32, (V, K), dev)
        _build.check_tensor(self.counts, "counts", torch.int64, (3,), dev)
        _build.check_tensor(self.aux, "aux", torch.int32,
                            (3, nw + -(-V // 32)), dev)
        for name in ("front", "next", "seen"):
            _build.check_tensor(getattr(self, name), name, torch.int32,
                                (V, nw), dev)


def msbfs_start(graph, sources, state: MsbfsState) -> None:
    """Write the start of ``state``'s searches, search k from
    ``sources[k]`` (int64, in [0, V)) into a state made by
    :meth:`MsbfsState.empty`: its bit into ``front``, ``seen`` and aux
    slot 0, ``dist[sources[k], k] = 0``, and ``counts`` = [distinct source
    vertices, 0, 0]. Two sources may share a vertex. CUDA source:
    ``csrc/msbfs.cu`` (``gr_msbfs_start``, one block)."""
    with annotate("kernel.msbfs_start"):
        dev = graph.device
        K = state.dist.shape[1]
        _build.check_tensor(sources, "sources", torch.int64, (K,), dev)
        state.check(graph)
        if dev.type == "cpu":
            return msbfs_start_plain(graph, sources, state)
        if dev.type != "cuda":
            raise ValueError(f"no multi-source BFS kernel for device {dev}")
        lib = _build.load("msbfs", _SIGNATURES)
        err = lib.gr_msbfs_start(
            _build.ptr(sources), K, graph.n_vertices, n_words(K),
            _build.ptr(state.front), _build.ptr(state.seen),
            _build.ptr(state.aux), _build.ptr(state.dist),
            _build.ptr(state.counts), _build.stream(dev))
        _build.check(err, "msbfs_start")
        _build.LAUNCHES["msbfs_start"] += 1
        return None


def msbfs_pull(graph, state: MsbfsState, level: int) -> None:
    """One level, ``level``, of the searches (see the module docstring):
    reads ``front``, writes ``next`` whole, updates ``seen``, ``dist``,
    ``aux`` and ``counts`` in place, then swaps ``front`` and ``next``.
    CUDA source: ``csrc/msbfs.cu`` (``gr_msbfs_pull``)."""
    with annotate("kernel.msbfs_pull"):
        dev = graph.device
        state.check(graph)
        if dev.type == "cpu":
            return msbfs_pull_plain(graph, state, level)
        if dev.type != "cuda":
            raise ValueError(f"no multi-source BFS kernel for device {dev}")
        lib = _build.load("msbfs", _SIGNATURES)
        err = lib.gr_msbfs_pull(
            _build.ptr(graph.csc_offsets), _build.ptr(graph.csc_rows),
            _build.ptr(state.front), _build.ptr(state.seen),
            _build.ptr(state.next), _build.ptr(state.aux),
            _build.ptr(state.dist), _build.ptr(state.counts),
            graph.n_vertices, graph.n_edges, state.front.shape[1],
            state.dist.shape[1], int(level), _build.sm_count(dev),
            _build.stream(dev))
        _build.check(err, "msbfs_pull")
        _build.LAUNCHES["msbfs_pull"] += 1
        state.front, state.next = state.next, state.front
        return None


def _mask(n_searches: int, w: int) -> int:
    """Word w's search bits as an int32 value."""
    m = (1 << min(32, n_searches - 32 * w)) - 1
    return m - (1 << 32) if m >= 1 << 31 else m


def _int32(v):
    """int32: an int64 tensor of uint32 bit patterns."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _to_bits(words):
    """bool[N, 32]: the bits of int32[N] words."""
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    return (words[:, None] >> shift) & 1 != 0


def _to_words(bits):
    """int32[N]: the words of bool[N, 32] bits (their bit patterns)."""
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    return _int32((bits.long() << shift).sum(1))


def _bitmap(rows_set, n_vertices: int):
    """int32[ceil(V / 32)]: bit v % 32 of word v // 32 where rows_set[v]."""
    pad = torch.zeros(-(-n_vertices // 32) * 32, dtype=torch.bool,
                      device=rows_set.device)
    pad[:n_vertices] = rows_set
    return _to_words(pad.view(-1, 32))


def _slot(words, n_vertices: int):
    """An aux slot for the frontier ``words`` [V, nw]: its live words (the
    OR of each column) and its bitmap."""
    live = _to_words(torch.stack([_to_bits(words[:, w]).any(0)
                                  for w in range(words.shape[1])]))
    return torch.cat([live, _bitmap((words != 0).any(1), n_vertices)])


def msbfs_start_plain(graph, sources, state: MsbfsState) -> None:
    """Plain PyTorch version of :func:`msbfs_start`: the bits scattered by
    an accumulating ``index_put_`` (each search's bit is its own, so the sum
    is the OR)."""
    k = torch.arange(sources.shape[0], device=sources.device)
    bits = torch.zeros(state.front.shape, dtype=torch.int64,
                       device=sources.device).index_put_(
        (sources, k // 32), torch.ones_like(k) << (k % 32), accumulate=True)
    bits = _int32(bits)
    state.front |= bits
    state.seen |= bits
    state.aux[0] = _slot(state.front, graph.n_vertices)
    state.dist[sources, k] = 0
    state.counts[0] = torch.unique(sources).numel()
    state.counts[1:] = 0


def msbfs_pull_plain(graph, state: MsbfsState, level: int) -> None:
    """Plain PyTorch version of :func:`msbfs_pull`: for each word and bit,
    the first slot of each run whose source's word holds the bit (a
    segment min of the slots' places in their runs); a scanned run's slots
    are the largest of those over its needed bits, or the run where one is
    missing."""
    V, K = state.dist.shape
    dev = state.front.device
    rows, dst = graph.csc_rows.long(), graph.csc_dst.long()
    off = graph.csc_offsets.long()
    place = torch.arange(graph.n_edges, device=dev) - off[dst]
    length = off[1:] - off[:-1]
    far = graph.n_edges + 1  # past every run
    live = state.aux[level % 3]
    found = torch.zeros(V, dtype=torch.bool, device=dev)
    slots = torch.zeros((), dtype=torch.int64, device=dev)
    for w in range(state.front.shape[1]):
        need = _to_bits(~state.seen[:, w] & _mask(K, w) & live[w])
        has = _to_bits(state.front[rows, w])
        first = torch.full((V, 32), far, dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, dst[:, None].expand(-1, 32),
            torch.where(has, place[:, None], far), "amin")
        got = need & (first < far)
        used = torch.where((got == need).all(1),
                           torch.where(need, first + 1, 0).amax(1), length)
        slots += torch.where(need.any(1), used, 0).sum()
        word = _to_words(got)
        state.next[:, w] = word
        state.seen[:, w] |= word
        n = min(32, K - 32 * w)
        state.dist[:, 32 * w:32 * w + n].masked_fill_(got[:, :n], level + 1)
        found |= got.any(1)
    state.aux[(level + 1) % 3] = _slot(state.next, V)
    state.aux[(level + 2) % 3] = 0
    state.counts[level % 2] = 0
    state.counts[(level + 1) % 2] += found.sum()
    state.counts[2] += slots
    state.front, state.next = state.next, state.front
