"""Graph coloring of the PyTorch port against the JAX package, on a
symmetric and a directed random graph (self loops included) carried across
with ``Graph.from_arrays``, the coloring layouts carried across with
``BucketedEdges.from_arrays`` (W=128/C=256, the JAX Pallas kernels in
interpret mode).

Everything is compared exactly: colors and iteration counts. The seeded
kernel functions get the JAX package's own priorities (its PRNG's
permutation) through ``priorities=``; the rank and greedy kernel bodies
are deterministic."""

import dataclasses

import numpy as np
import pytest
import torch

from gunrock_tpu.algorithms import color as jcolor
from gunrock_tpu.formats import Coo as JCoo
from gunrock_tpu.graph import build_graph as j_build_graph
from gunrock_tpu.graph.properties import GraphProperties as JGraphProperties
from gunrock_tpu.ops.pallas.layout import build_bucketed_layout as j_build_layout

from gunrock_tpu_torch.algorithms import color
from gunrock_tpu_torch.examples import cpu_reference
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.ops.configs import LoadBalance, Options
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
)

V, W, C = 300, 128, 256


def _edges(symmetric: bool):
    """Skewed random edges with a few self loops; both directions of every
    edge when ``symmetric``."""
    rng = np.random.default_rng(3 if symmetric else 4)
    n = 1500
    rows = (V * rng.random(n) ** 2).astype(np.int32)
    cols = rng.integers(0, V, n).astype(np.int32)
    rows[:10] = cols[:10]  # self loops
    if symmetric:
        rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    key = np.unique(rows.astype(np.int64) * V + cols)
    return (key // V).astype(np.int32), (key % V).astype(np.int32)


def _carry_layout(jl) -> BucketedEdges:
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


@pytest.fixture(scope="module", params=["symmetric", "directed"])
def graphs(request):
    """(JAX graph, port graph, {kind: (JAX layout, port layout)}, greedy
    rank as numpy)."""
    symmetric = request.param == "symmetric"
    rows, cols = _edges(symmetric)
    jg = j_build_graph(
        JCoo(n_rows=V, n_cols=V, row_indices=rows, col_indices=cols,
             values=np.ones(rows.size, np.float32)),
        JGraphProperties(directed=not symmetric, symmetric=symmetric))
    tg = Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, V,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")
    src, dst = color._sym_loopfree_edges(tg)
    assert (src != dst).all() and src.size < 2 * rows.size
    layouts = {}
    for kind, vals, build in (
            ("luby", np.ones(src.size, np.float32), color._color_layout),
            ("rank", (dst < src).astype(np.float32), color._rank_color_layout)):
        jl = j_build_layout(src, dst, vals, V, window=W, chunk=C)
        tl = _carry_layout(jl)
        # the port's own layout function gives the same layout
        own = build(tg, window=W, chunk=C)
        for k in DATA_FIELDS:
            assert torch.equal(getattr(own, k), getattr(tl, k)), (kind, k)
        layouts[kind] = (jl, tl)
    rank = color._greedy_color_setup(tg, window=W, chunk=C)[1].numpy()
    return jg, tg, layouts, rank


def _check(tg, got, want):
    colors, it = got
    jcolors, jit = want
    np.testing.assert_array_equal(colors.numpy(), np.asarray(jcolors))
    assert it == int(jit) > 0
    assert cpu_reference.color_is_valid(tg, colors.numpy())


@pytest.mark.parametrize("ordering", ["random", "degree"])
def test_color_kernel_matches_jax(graphs, ordering):
    jg, tg, _, _ = graphs
    prio = np.asarray(jcolor.make_priorities(jg, 5, ordering))
    _check(tg, color.color_kernel(tg, priorities=prio),
           jcolor.color_kernel(jg, seed=5, ordering=ordering))


def test_color_kernel_rank_matches_jax(graphs):
    jg, tg, _, _ = graphs
    prio = np.asarray(jcolor.make_priorities(jg, 6))
    _check(tg, color.color_kernel_rank(tg, priorities=prio),
           jcolor.color_kernel_rank(jg, seed=6))


def test_color_kernel_greedy_matches_jax(graphs):
    jg, tg, _, _ = graphs
    _check(tg, color.color_kernel_greedy(tg), jcolor.color_kernel_greedy(jg))
    # K=4 saturates its windows: the stall and phase-spread rules run
    _check(tg, color.color_kernel_greedy(tg, K=4),
           jcolor.color_kernel_greedy(jg, K=4))


def test_color_kernel_pallas_matches_jax(graphs):
    """Luby on the fused max/min pass."""
    jg, tg, layouts, _ = graphs
    jl, tl = layouts["luby"]
    prio = np.asarray(jcolor.make_priorities(jg, 7))
    _check(tg, color.color_kernel_pallas(tg, layout=tl, priorities=prio),
           jcolor.color_kernel_pallas(jg, seed=7, layout=jl, interpret=True))


def test_color_kernel_rank_pallas_matches_jax(graphs):
    """Rank JP on two frontier-sparse semiring passes per round."""
    jg, tg, layouts, _ = graphs
    jl, tl = layouts["rank"]
    _check(tg, color.color_kernel_rank_pallas(tg, layout=tl),
           jcolor.color_kernel_rank_pallas(jg, layout=jl, interpret=True))


@pytest.mark.parametrize("K", [32, 4])
def test_color_kernel_greedy_pallas_matches_jax(graphs, K):
    """Greedy on the frontier-sparse SpMM, cnt carried across rounds; K=4
    saturates its windows, so the stall and phase-spread rules run."""
    import jax.numpy as jnp

    jg, tg, layouts, rank = graphs
    jl, tl = layouts["rank"]
    _check(tg,
           color.color_kernel_greedy_pallas(tg, torch.from_numpy(rank),
                                            layout=tl, K=K),
           jcolor.color_kernel_greedy_pallas(jg, jnp.asarray(rank), layout=jl,
                                             interpret=True, K=K))


def test_make_priorities_is_a_seeded_permutation(graphs):
    _, tg, _, _ = graphs
    a = color.make_priorities(tg, 1).numpy()
    np.testing.assert_array_equal(np.sort(a), np.arange(V))
    np.testing.assert_array_equal(a, color.make_priorities(tg, 1).numpy())
    assert (a != color.make_priorities(tg, 2).numpy()).any()
    d = color.make_priorities(tg, 1, "degree").numpy()
    deg = np.diff(tg.host["row_offsets"])
    order = np.argsort(d)
    assert (np.diff(deg[order]) >= 0).all()  # higher degree, higher priority
    with pytest.raises(ValueError):
        color.make_priorities(tg, 1, "nope")


@pytest.mark.parametrize("path", ["kernels", "plain"])
@pytest.mark.parametrize("strategy", ["auto", "luby", "rank", "greedy"])
def test_run_colors_properly(graphs, strategy, path):
    _, tg, _, _ = graphs
    lb = (LoadBalance.PALLAS_MERGE_PATH if path == "kernels"
          else LoadBalance.XLA_SEGMENT)
    res = color.run(tg, seed=2, options=Options(load_balance=lb),
                    strategy=strategy, device="cpu")
    colors = res.colors.numpy()
    assert colors.dtype == np.int32 and (colors != -1).all()
    assert cpu_reference.color_is_valid(tg, colors)
    assert res.iterations > 0 and res.elapsed_ms >= 0
    with pytest.raises(ValueError):
        color.run(tg, strategy="nope", device="cpu")
