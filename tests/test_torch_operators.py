"""The port's operator layer (``ops/``, ``framework/frontier.py``,
``utils/limits.py``, ``io/sample.py``, the CLI operator flags) against the
JAX package, on the same numpy inputs made from a seed.

Graphs: ``io.sample.small_connected_graph``, ``tests/conftest.random_graph``
at n=40 (directed, p=0.2) and n=300 (symmetric, p=0.02), chesapeake, and
R-MAT scale 9 degree-sorted; each carried across with
``Graph.from_arrays``. R-MAT and the sparse random graphs have vertices
with no in-edge and no out-edge, so empty segments are exercised.

Tolerances: min, max, integer and queue results are exact. Float sums are
held within rtol 1e-4 and atol 8 * 2^-24 * sum|messages|: the sorted-sum
path (``seg_sum_sorted``, a cumsum difference, in both packages) carries
the error of the whole prefix, about an ulp of the total, whatever the
row's size. JAX's ``PALLAS_MERGE_PATH`` runs its Pallas kernels in
interpret mode; the port's runs the kernels' plain versions on the CPU.
The torch side always gets its own copy of a numpy input (``torch.tensor``):
on the CPU, JAX may share the memory of a numpy array handed to it, and a
torch view of the same array then read wrong values in this file's
haversine test, one run in five.
"""

import dataclasses
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gunrock_tpu.ops as j_ops
from gunrock_tpu.framework import frontier as j_frontier
from gunrock_tpu.graph.reorder import degree_sort as j_degree_sort
from gunrock_tpu.io import sample as j_sample
from gunrock_tpu.io.generators import rmat_graph as j_rmat_graph
from gunrock_tpu.io.loader import load_graph_file as j_load_graph_file
from gunrock_tpu.ops import configs as j_configs
from gunrock_tpu.ops import parallel_for as j_pfor
from gunrock_tpu.ops import search as j_search
from gunrock_tpu.ops import sort as j_sort
from gunrock_tpu.utils import limits as j_limits

import gunrock_tpu_torch.ops as t_ops
from gunrock_tpu_torch.framework import frontier as t_frontier
from gunrock_tpu_torch.graph import Graph, GraphProperties
from gunrock_tpu_torch.graph.graph import ARRAYS
from gunrock_tpu_torch.io import sample as t_sample
from gunrock_tpu_torch.ops import configs as t_configs
from gunrock_tpu_torch.ops import parallel_for as t_pfor
from gunrock_tpu_torch.ops import random as t_random
from gunrock_tpu_torch.ops import search as t_search
from gunrock_tpu_torch.ops import sort as t_sort
from gunrock_tpu_torch.utils import limits as t_limits

from tests.conftest import random_graph

# the packages' ops/__init__ rebind ``advance`` to the function
j_advance = importlib.import_module("gunrock_tpu.ops.advance")
t_advance = importlib.import_module("gunrock_tpu_torch.ops.advance")

ROOT = Path(__file__).resolve().parent.parent
CHESAPEAKE = str(ROOT / "datasets" / "chesapeake.mtx")
F32_ULP = 2.0 ** -24


def to_port(jg) -> Graph:
    return Graph.from_arrays(
        {k: np.asarray(getattr(jg, k)) for k in ARRAYS}, jg.n_vertices,
        GraphProperties(**dataclasses.asdict(jg.properties)), device="cpu")


def _jax_graph(name: str):
    if name == "sample":
        return j_sample.small_connected_graph()
    if name == "random40":
        return random_graph(None, n=40, p=0.2)[0]
    if name == "random300_sym":
        return random_graph(None, n=300, p=0.02, symmetric=True,
                            seed_offset=3)[0]
    if name == "chesapeake":
        return j_load_graph_file(CHESAPEAKE)[0]
    return j_degree_sort(j_rmat_graph(scale=9, seed=1))[0]


GRAPHS = ("sample", "random40", "random300_sym", "chesapeake", "rmat9")
_CACHE = {}


@pytest.fixture(params=GRAPHS)
def pair(request):
    """(JAX graph, port graph), built once per name."""
    name = request.param
    if name not in _CACHE:
        jg = _jax_graph(name)
        _CACHE[name] = (jg, to_port(jg))
    return _CACHE[name]


def j2n(a):
    return np.asarray(a)


def t2n(a):
    return a.cpu().numpy()


def assert_sum_close(got, want, terms):
    """Float sums: rtol 1e-4, atol 8 * 2^-24 * sum|terms| (the module
    docstring)."""
    atol = 8 * F32_ULP * float(np.abs(np.asarray(terms, np.float64)).sum())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=max(atol, 1e-7))


def assert_same(got, want):
    """Exact, with infinities (and their signs) in the same places."""
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)


# -- utils/limits ---------------------------------------------------------------

DTYPES = {"int32": (torch.int32, jnp.int32), "int16": (torch.int16, jnp.int16),
          "uint8": (torch.uint8, jnp.uint8), "float32": (torch.float32, jnp.float32),
          "float16": (torch.float16, jnp.float16)}


@pytest.mark.parametrize("name", list(DTYPES))
def test_limits_match_jax(name):
    tdt, jdt = DTYPES[name]
    np.testing.assert_array_equal(
        t2n(t_limits.invalid(tdt, "cpu")), j2n(j_limits.invalid(jdt)))
    for red in ("sum", "min", "max"):
        got = t_limits.reduce_identity(tdt, red, "cpu")
        assert got.dtype == tdt and got.dim() == 0
        np.testing.assert_array_equal(
            t2n(got), j2n(j_limits.reduce_identity(jdt, red)))
    np.testing.assert_array_equal(
        t2n(t_limits.unreached(tdt, "cpu")), j2n(j_limits.unreached(jdt)))
    x = np.array([0, 1, 7, 100], np.dtype(jdt))
    kind = np.dtype(jdt).kind
    x[2] = np.nan if kind == "f" else -1 if kind == "i" else \
        np.iinfo(np.dtype(jdt)).max
    np.testing.assert_array_equal(
        t2n(t_limits.is_valid(torch.tensor(x))),
        j2n(j_limits.is_valid(jnp.asarray(x))))
    assert t_limits.INVALID_VERTEX == j_limits.INVALID_VERTEX == -1
    assert t_limits.INVALID_EDGE == j_limits.INVALID_EDGE == -1


def test_limits_of_64_bit_types():
    """The types the JAX package reaches only under x64: against numpy."""
    assert int(t_limits.invalid(torch.int64, "cpu")) == -1
    assert torch.isnan(t_limits.invalid(torch.float64, "cpu"))
    assert int(t_limits.unreached(torch.int64, "cpu")) == np.iinfo(np.int64).max
    assert int(t_limits.reduce_identity(torch.int64, "max", "cpu")) == \
        np.iinfo(np.int64).min
    assert float(t_limits.unreached(torch.float64, "cpu")) == np.inf


def test_limits_bool_and_errors():
    assert not bool(t_limits.invalid(torch.bool, "cpu"))
    m = torch.tensor([True, False])
    assert torch.equal(t_limits.is_valid(m), m)
    assert not bool(t_limits.reduce_identity(torch.float32, "or", "cpu"))
    with pytest.raises(ValueError):
        t_limits.reduce_identity(torch.float32, "mean", "cpu")


# -- ops/configs and the CLI flags -------------------------------------------------


@pytest.mark.parametrize("enum", ["LoadBalance", "AdvanceDirection", "AdvanceIO",
                                  "FilterAlgorithm", "UniquifyAlgorithm"])
def test_enums_match_jax(enum):
    j, t = getattr(j_configs, enum), getattr(t_configs, enum)
    assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]


@pytest.mark.parametrize("name", ["bypass", "predicated", "remove", "compact",
                                  " Compact "])
def test_filter_algorithm_parse(name):
    assert t_configs.FilterAlgorithm.parse(name).value == \
        j_configs.FilterAlgorithm.parse(name).value


def test_filter_algorithm_parse_rejects():
    with pytest.raises(ValueError):
        t_configs.FilterAlgorithm.parse("sorted")


def test_options_fields_and_defaults_match_jax():
    def fields(cls):
        out = {}
        for f in dataclasses.fields(cls):
            v = f.default
            out[f.name] = v.value if hasattr(v, "value") else v
        return out

    assert fields(t_configs.Options) == fields(j_configs.Options)
    # the port's default options stay its own (the kernels on every device)
    d = t_configs.default_options()
    assert d.load_balance == t_configs.LoadBalance.PALLAS_MERGE_PATH
    assert d.advance_direction == t_configs.AdvanceDirection.OPTIMIZED


CLIS = ("bfs", "sssp", "pr", "hits", "spmv", "color", "mst", "kcore", "ppr",
        "bc", "tc", "spgemm", "geo")
SIX_FLAGS = ("--filter_algorithm", "--enable_filter", "--enable_uniquify",
             "--uniquify_algorithm", "--best_effort_uniquify",
             "--uniquify_percent")


class _Parser(Exception):
    pass


def _cli_options(pkg: str, name: str, monkeypatch) -> dict:
    """{option: default} of a CLI's parser, caught where its main() parses."""
    mod = importlib.import_module(f"{pkg}.examples.{name}")
    params = importlib.import_module(f"{pkg}.io.parameters")

    def catch(algorithm, argv=None, extra_args=None):
        p = params.build_parser(algorithm, extra_args)
        raise _Parser({a.option_strings[-1]: a.default for a in p._actions
                       if a.option_strings})

    monkeypatch.setattr(mod, "parse", catch)
    with pytest.raises(_Parser) as got:
        mod.main(["--market", CHESAPEAKE])
    return got.value.args[0]


@pytest.mark.parametrize("name", CLIS)
def test_cli_option_sets_match_jax(name, monkeypatch):
    """Every port CLI has the JAX CLI's options with the same defaults,
    the six operator flags and the async sweep's ``--mode``/``--ordering``
    among them. Known differences: the port adds ``--device`` (and mst its
    ``--strategy``, ROADMAP C)."""
    j = _cli_options("gunrock_tpu", name, monkeypatch)
    t = _cli_options("gunrock_tpu_torch", name, monkeypatch)
    port_only = {"--device"} | ({"--strategy"} if name == "mst" else set())
    assert set(t) - set(j) == port_only
    assert set(j) - set(t) == set()
    assert {k: t[k] for k in set(j) & set(t)} == \
        {k: j[k] for k in set(j) & set(t)}
    assert set(SIX_FLAGS) <= set(t)


def test_cli_flags_parse_into_options():
    from gunrock_tpu.io.parameters import parse as j_parse
    from gunrock_tpu_torch.io.parameters import parse as t_parse

    argv = ["-m", CHESAPEAKE, "--filter_algorithm", "compact",
            "--enable_uniquify", "--uniquify_algorithm", "unique_copy",
            "--best_effort_uniquify", "--uniquify_percent", "40"]
    for extra in ([], ["--uniquify_algorithm", "bogus"]):
        jo, to = j_parse("bfs", argv + extra).options, \
            t_parse("bfs", argv + extra).options
        for f in ("filter_algorithm", "uniquify_algorithm"):
            assert getattr(to, f).value == getattr(jo, f).value
        for f in ("enable_filter", "enable_uniquify", "best_effort_uniquify",
                  "uniquify_percent"):
            assert getattr(to, f) == getattr(jo, f)


def _cli_parse_args(pkg: str, name: str, monkeypatch) -> tuple:
    """(algorithm, extra_args) that a CLI's main() hands to ``parse``."""
    mod = importlib.import_module(f"{pkg}.examples.{name}")

    def catch(algorithm, argv=None, extra_args=None):
        raise _Parser(algorithm, extra_args)

    monkeypatch.setattr(mod, "parse", catch)
    with pytest.raises(_Parser) as got:
        mod.main(["--market", CHESAPEAKE])
    return got.value.args


@pytest.mark.parametrize("name", CLIS)
def test_every_cli_parses_binary_as_jax(name, monkeypatch):
    """``Parameters.binary`` is ``is_binary_csr(--market)`` in both
    packages, and each CLI's flags parse into the same common fields."""
    import dataclasses

    from gunrock_tpu.io import parameters as j_params
    from gunrock_tpu_torch.io import parameters as t_params

    j_args = _cli_parse_args("gunrock_tpu", name, monkeypatch)
    t_args = _cli_parse_args("gunrock_tpu_torch", name, monkeypatch)
    assert j_args[0] == t_args[0]
    t_fields = [f.name for f in dataclasses.fields(t_params.Parameters)]
    common = [f.name for f in dataclasses.fields(j_params.Parameters)
              if f.name in t_fields and f.name not in ("options", "extra")]
    assert "binary" in common
    # JAX's order of fields, the port's device and reorder after binary
    assert t_fields.index("binary") == t_fields.index("options") + 1
    for market, binary in (("graph.csr", True), (CHESAPEAKE, False)):
        argv = ["-m", market, "-n", "2", "-t", "a,b"]
        jp = j_params.parse(j_args[0], argv, j_args[1])
        tp = t_params.parse(t_args[0], argv, t_args[1])
        assert tp.binary is jp.binary is binary
        assert {f: getattr(tp, f) for f in common} == \
            {f: getattr(jp, f) for f in common}


def test_ops_names_match_jax():
    def names(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(mod))}

    assert names(t_ops) == names(j_ops)


# -- io/sample ------------------------------------------------------------------


def test_sample_csr_matches_jax():
    t, j = t_sample.csr(), j_sample.csr()
    for f in ("n_rows", "n_cols", "row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("make", ["graph", "small_connected_graph"])
def test_sample_graphs_match_jax(make):
    jg = getattr(j_sample, make)()
    tg = getattr(t_sample, make)(device="cpu")
    assert (tg.n_vertices, tg.n_edges) == (jg.n_vertices, jg.n_edges)
    for k in ARRAYS:
        np.testing.assert_array_equal(t2n(getattr(tg, k)),
                                      j2n(getattr(jg, k)), err_msg=k)
    assert dataclasses.asdict(tg.properties) == \
        dataclasses.asdict(jg.properties)


# -- framework/frontier ---------------------------------------------------------


def _queue(seed: int, capacity: int, n_vertices: int, count: int,
           invalid_share: float = 0.1):
    """A padded queue with repeats and some invalid live entries."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, n_vertices, capacity).astype(np.int32)
    data[rng.random(capacity) < invalid_share] = -1
    data[count:] = -1
    return data, np.int32(count)


QUEUES = [(0, 64, 20, 50), (1, 64, 20, 0), (2, 64, 200, 64), (3, 1, 5, 1),
          (4, 128, 7, 100)]


@pytest.mark.parametrize("seed,cap,n,count", QUEUES)
def test_queue_to_mask_matches_jax(seed, cap, n, count):
    data, c = _queue(seed, cap, n, count)
    np.testing.assert_array_equal(
        t2n(t_frontier.queue_to_mask(torch.tensor(data), torch.tensor(c),
                                     n)),
        j2n(j_frontier.queue_to_mask(jnp.asarray(data), jnp.int32(c), n)))


@pytest.mark.parametrize("share,cap", [(0.3, 64), (0.3, 10), (0.0, 8),
                                       (1.0, 50), (1.0, 200)])
def test_mask_to_queue_matches_jax(share, cap):
    """Also with more set bits than capacity: the count is sum(mask)."""
    mask = np.random.default_rng(5).random(100) < share
    td, tc = t_frontier.mask_to_queue(torch.tensor(mask), cap)
    jd, jc = j_frontier.mask_to_queue(jnp.asarray(mask), cap)
    assert_same(t2n(td), j2n(jd))
    assert int(tc) == int(jc) == int(mask.sum())
    assert tc.dtype == torch.int32 and tc.dim() == 0


def test_dense_frontier_matches_jax():
    J, T = j_frontier.DenseFrontier, t_frontier.DenseFrontier
    for jf, tf in ((J.empty(9), T.empty(9, device="cpu")),
                   (J.single(9, 4), T.single(9, 4, device="cpu")),
                   (J.all(9), T.all(9, device="cpu"))):
        np.testing.assert_array_equal(t2n(tf.mask), j2n(jf.mask))
        assert int(tf.get_number_of_elements()) == \
            int(jf.get_number_of_elements())
        assert bool(tf.is_empty()) == bool(jf.is_empty())


def test_queue_frontier_matches_jax():
    """Every method, step by step, against the JAX queue (including a
    push past the capacity, which drops the element and grows count)."""
    J, T = j_frontier.QueueFrontier, t_frontier.QueueFrontier
    jq, tq = J.with_capacity(5), T.with_capacity(5, device="cpu")

    def same(jq, tq):
        assert_same(t2n(tq.data), j2n(jq.data))
        assert int(tq.count) == int(jq.count)
        assert tq.count.dtype == torch.int32 and tq.count.dim() == 0
        assert tq.capacity == jq.capacity
        np.testing.assert_array_equal(t2n(tq.live_mask()), j2n(jq.live_mask()))
        assert bool(tq.is_empty()) == bool(jq.is_empty())

    same(jq, tq)
    for v in (3, 1, 4, 1, 5, 9):
        jq, tq = jq.push_back(v), tq.push_back(v)
        same(jq, tq)
    assert int(tq.get_number_of_elements()) == 6
    assert int(tq.get_element_at(2)) == int(jq.get_element_at(2)) == 4
    same(jq.sort(), tq.sort())
    same(jq.set_element_at(0, 7), tq.set_element_at(0, 7))
    same(jq.fill(2), tq.fill(2))
    same(jq.sequence(10, 3), tq.sequence(10, 3))
    np.testing.assert_array_equal(t2n(tq.to_mask(12)), j2n(jq.to_mask(12)))
    for items in ([4, 2, 9], np.array([8, 8], np.int64), torch.tensor([1])):
        jl = items.numpy() if isinstance(items, torch.Tensor) else items
        same(J.from_list(jl, 6), T.from_list(items, 6, device="cpu"))


def test_queue_frontier_leaves_its_input_untouched():
    q = t_frontier.QueueFrontier.from_list([5, 3], 4, device="cpu")
    before = q.data.clone()
    q.push_back(1), q.set_element_at(0, 9), q.sort(), q.fill(0)
    assert torch.equal(q.data, before) and int(q.count) == 2


def test_queue_frontier_print(capsys):
    t_frontier.QueueFrontier.from_list([5, 3], 4, device="cpu").print("q", 3)
    assert capsys.readouterr().out.strip() == "q (count=2): [ 5  3 -1]"


# -- ops/sort, ops/search, ops/random ---------------------------------------------


def test_sort_keys_and_pairs_match_jax():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 20, 300).astype(np.int32)
    vals = rng.random(300).astype(np.float32)
    np.testing.assert_array_equal(t2n(t_sort.sort_keys(torch.tensor(keys))),
                                  j2n(j_sort.sort_keys(jnp.asarray(keys))))
    tk, tv = t_sort.sort_pairs(torch.tensor(keys), torch.tensor(vals))
    jk, jv = j_sort.sort_pairs(jnp.asarray(keys), jnp.asarray(vals))
    np.testing.assert_array_equal(t2n(tk), j2n(jk))
    np.testing.assert_array_equal(t2n(tv), j2n(jv))  # stable: same payload


@pytest.mark.parametrize("side", ["left", "right"])
def test_binary_search_matches_jax(side):
    rng = np.random.default_rng(12)
    arr = np.sort(rng.integers(0, 50, 200)).astype(np.int32)
    needles = rng.integers(-5, 60, 100).astype(np.int32)
    got = t_search.binary_search(torch.tensor(arr), torch.tensor(needles),
                                 side)
    assert_same(t2n(got), j2n(j_search.binary_search(
        jnp.asarray(arr), jnp.asarray(needles), side)))


def test_binary_search_rejects_side():
    with pytest.raises(ValueError):
        t_search.binary_search(torch.arange(3), torch.arange(2), "middle")


def test_bounded_binary_search_matches_jax():
    rng = np.random.default_rng(13)
    arr = np.sort(rng.integers(0, 40, 64)).astype(np.int32)
    for needle, lo, hi in [(0, 0, 64), (17, 5, 40), (39, 0, 64), (50, 10, 20),
                           (-1, 0, 64), (20, 30, 30)]:
        want = int(j_search.bounded_binary_search(jnp.asarray(arr), needle,
                                                  jnp.int32(lo), jnp.int32(hi)))
        got = t_search.bounded_binary_search(torch.tensor(arr), needle,
                                             lo, hi)
        assert int(got) == want


def test_bounded_binary_search_under_vmap():
    arr = torch.tensor([1, 3, 3, 7, 9], dtype=torch.int32)
    needles = torch.tensor([0, 3, 8, 10], dtype=torch.int32)
    got = torch.func.vmap(lambda n: t_search.bounded_binary_search(
        arr, n, 0, 5, steps=4))(needles)
    np.testing.assert_array_equal(t2n(got), [0, 1, 4, 5])


@pytest.mark.parametrize("seed", [0, 7])
def test_random_fills_range_dtype_determinism(seed):
    """Not JAX's threefry stream (ROADMAP C): range, dtype, shape and the
    same values for the same seed."""
    u = t_random.uniform(1000, seed, -2.0, 3.0, device="cpu")
    assert u.dtype == torch.float32 and u.shape == (1000,)
    assert float(u.min()) >= -2.0 and float(u.max()) < 3.0
    assert torch.equal(u, t_random.uniform(1000, seed, -2.0, 3.0, device="cpu"))
    assert not torch.equal(u, t_random.uniform(1000, seed + 1, -2.0, 3.0,
                                               device="cpu"))
    i = t_random.uniform_int(1000, seed, 5, 9, device="cpu")
    assert i.dtype == torch.int32 and i.shape == (1000,)
    assert set(t2n(i).tolist()) == {5, 6, 7, 8}
    assert torch.equal(i, t_random.uniform_int(1000, seed, 5, 9, device="cpu"))
    d = t_random.uniform(10, seed, dtype=torch.float64, device="cpu")
    assert d.dtype == torch.float64


# -- ops/parallel_for ---------------------------------------------------------------


def test_parallel_for_matches_jax(pair):
    jg, tg = pair
    np.testing.assert_array_equal(
        t2n(t_pfor.for_each_vertex(tg, lambda v: v * 3 + 1)),
        j2n(j_pfor.for_each_vertex(jg, lambda v: v * 3 + 1)))
    np.testing.assert_allclose(
        t2n(t_pfor.for_each_edge(tg, lambda s, d, e, w: w * (s + 2 * d) + e)),
        j2n(j_pfor.for_each_edge(jg, lambda s, d, e, w: w * (s + 2 * d) + e)),
        rtol=1e-6)
    mask = np.random.default_rng(3).random(tg.n_vertices) < 0.4
    np.testing.assert_array_equal(
        t2n(t_pfor.for_each_in_frontier_mask(
            torch.tensor(mask), lambda v, m: v * m)),
        j2n(j_pfor.for_each_in_frontier_mask(
            jnp.asarray(mask), lambda v, m: v * m)))
    data, c = _queue(4, 32, tg.n_vertices, 20)
    np.testing.assert_array_equal(
        t2n(t_pfor.for_each_in_queue(torch.tensor(data), torch.tensor(c),
                                     lambda x, live: x * live)),
        j2n(j_pfor.for_each_in_queue(jnp.asarray(data), jnp.int32(c),
                                     lambda x, live: x * live)))


# -- ops/filter and ops/uniquify ------------------------------------------------------


def test_filter_mask():
    mask = torch.tensor([True, True, False, True])
    pred = torch.tensor([True, False, True, True])
    np.testing.assert_array_equal(t2n(t_ops.filter_mask(mask, pred)),
                                  [True, False, False, True])


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("seed,cap,n,count", QUEUES)
def test_filter_queue_matches_jax(seed, cap, n, count, compact):
    data, c = _queue(seed, cap, n, count)
    td, tc = t_ops.filter_queue(torch.tensor(data), torch.tensor(c),
                                lambda x: x % 3 != 1, compact=compact)
    jd, jc = j_ops.filter_queue(jnp.asarray(data), jnp.int32(c),
                                lambda x: x % 3 != 1, compact=compact)
    assert_same(t2n(td), j2n(jd))
    assert int(tc) == int(jc) and tc.dtype == torch.int32
    if not compact:
        assert int(tc) == count  # bypass keeps the count


ALGOS = [("SCATTER", False), ("UNIQUE", False), ("UNIQUE", True),
         ("UNIQUE_COPY", False), ("UNIQUE_COPY", True)]


@pytest.mark.parametrize("algo,best_effort", ALGOS)
@pytest.mark.parametrize("seed,cap,n,count", QUEUES)
def test_uniquify_matches_jax(seed, cap, n, count, algo, best_effort):
    data, c = _queue(seed, cap, n, count)
    td, tc = t_ops.uniquify(torch.tensor(data), torch.tensor(c), n,
                            getattr(t_configs.UniquifyAlgorithm, algo),
                            best_effort)
    jd, jc = j_ops.uniquify(jnp.asarray(data), jnp.int32(c), n,
                            getattr(j_configs.UniquifyAlgorithm, algo),
                            best_effort)
    assert_same(t2n(td), j2n(jd))
    assert int(tc) == int(jc)


def test_uniquify_against_numpy():
    """SCATTER keeps first occurrences in queue order; UNIQUE ascends."""
    data, c = _queue(9, 200, 50, 180)
    live = data[:180][data[:180] >= 0]
    _, first = np.unique(live, return_index=True)
    for algo, want in (("SCATTER", live[np.sort(first)]),
                       ("UNIQUE", np.unique(live))):
        td, tc = t_ops.uniquify(torch.tensor(data), torch.tensor(c), 50,
                                getattr(t_configs.UniquifyAlgorithm, algo))
        assert int(tc) == want.size
        np.testing.assert_array_equal(t2n(td)[: want.size], want)
        assert (t2n(td)[want.size:] == -1).all()


# -- test_operators.py's cases on the port ----------------------------------------------


def test_advance_forward_min_sample():
    g = t_sample.small_connected_graph(device="cpu")
    mask = torch.zeros(7, dtype=torch.bool)
    mask[0] = True
    dist = torch.full((7,), torch.inf)
    dist[0] = 0.0
    reduced, touched = t_ops.advance(g, mask, lambda s, d, e, w: dist[s] + w,
                                     reduce="min")
    np.testing.assert_allclose(t2n(reduced)[[1, 2]], [2.0, 4.0])
    assert bool(touched[1]) and bool(touched[2]) and not bool(touched[3])


def test_advance_backward_pull_sample():
    g = t_sample.small_connected_graph(device="cpu")
    mask = torch.zeros(7, dtype=torch.bool)
    mask[3] = True
    reduced, touched = t_ops.advance(
        g, mask, lambda s, d, e, w: torch.ones_like(w), reduce="sum",
        direction=t_configs.AdvanceDirection.BACKWARD)
    np.testing.assert_allclose(t2n(reduced)[[1, 4]], [1.0, 1.0])
    assert bool(touched[1]) and bool(touched[4])


def test_advance_sum_matches_spmv():
    jg, sp_mat = random_graph(None, n=40, p=0.2)
    g = to_port(jg)
    x = torch.tensor(np.random.default_rng(7).random(40).astype(np.float32))
    y, _ = t_ops.advance(g, torch.ones(40, dtype=torch.bool),
                         lambda s, d, e, w: w * x[s], reduce="sum")
    np.testing.assert_allclose(t2n(y), sp_mat.T @ t2n(x), rtol=1e-4)


def test_neighbor_reduce_matches_spmv():
    jg, sp_mat = random_graph(None, n=40, p=0.2)
    g = to_port(jg)
    x = torch.tensor(np.random.default_rng(8).random(40).astype(np.float32))
    y = t_ops.neighbor_reduce(g, lambda s, d, e, w: w * x[d], reduce="sum")
    np.testing.assert_allclose(t2n(y), sp_mat @ t2n(x), rtol=1e-4)


def test_filter_queue_cases():
    q = t_frontier.QueueFrontier.from_list([4, 2, 9, 7, 2], 8, device="cpu")
    data, count = t_ops.filter_queue(q.data, q.count, lambda x: x % 2 == 0)
    assert int(count) == 3
    np.testing.assert_array_equal(t2n(data), [4, 2, 2, -1, -1, -1, -1, -1])
    q = t_frontier.QueueFrontier.from_list([4, 2, 9], 4, device="cpu")
    data, count = t_ops.filter_queue(q.data, q.count, lambda x: x > 3,
                                     compact=False)
    assert int(count) == 3
    np.testing.assert_array_equal(t2n(data), [4, -1, 9, -1])


def test_uniquify_cases():
    q = t_frontier.QueueFrontier.from_list([5, 3, 5, 1, 3, 5], 8, device="cpu")
    data, count = t_ops.uniquify(q.data, q.count, n_vertices=10)
    assert int(count) == 3
    np.testing.assert_array_equal(t2n(data)[:3], [5, 3, 1])
    data, count = t_ops.uniquify(q.data, q.count, n_vertices=10,
                                 algorithm=t_configs.UniquifyAlgorithm.UNIQUE)
    assert int(count) == 3
    np.testing.assert_array_equal(t2n(data)[:3], [1, 3, 5])


def test_mask_queue_roundtrip():
    mask = torch.tensor([False, True, True, False, True, False])
    data, count = t_frontier.mask_to_queue(mask, capacity=6)
    assert int(count) == 3
    np.testing.assert_array_equal(t2n(data)[:3], [1, 2, 4])
    assert torch.equal(t_frontier.queue_to_mask(data, count, 6), mask)


# -- ops/neighbor_reduce, edge_map_reduce, advance ------------------------------------


def _ops(xp, x, xi):
    """Edge ops over float and int32 vertex values, in either package."""
    return {
        "float": lambda s, d, e, w: w * x[d] - x[s],
        "int": lambda s, d, e, w: xi[s] * 3 + xi[d] - e,
        "ones": lambda s, d, e, w: xp.ones_like(w),
    }


def _values(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    xi = rng.integers(-50, 50, n).astype(np.int32)
    return x, xi


def _compare(got, want, reduce, kind, terms):
    if reduce == "sum" and kind == "float":
        assert_sum_close(got, want, terms)
    else:
        assert_same(got, want)


@pytest.mark.parametrize("reduce", ["min", "max", "sum"])
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("masked", [False, True])
def test_neighbor_reduce_matches_jax(pair, reduce, direction, kind, masked):
    jg, tg = pair
    x, xi = _values(tg.n_vertices)
    jop = _ops(jnp, jnp.asarray(x), jnp.asarray(xi))[kind]
    top = _ops(torch, torch.tensor(x), torch.tensor(xi))[kind]
    act = np.random.default_rng(1).random(tg.n_edges) < 0.5 if masked else None
    want = j2n(j_ops.neighbor_reduce(
        jg, jop, reduce, direction, None if act is None else jnp.asarray(act)))
    got = t2n(t_ops.neighbor_reduce(
        tg, top, reduce, direction, None if act is None else torch.tensor(act)))
    terms = j2n(jop(jg.edge_src, jg.col_indices,
                    jnp.arange(jg.n_edges), jg.values))
    _compare(got, want, reduce, kind, terms)


def test_neighbor_reduce_rejects_direction():
    g = t_sample.small_connected_graph(device="cpu")
    with pytest.raises(ValueError):
        t_ops.neighbor_reduce(g, lambda s, d, e, w: w, direction="both")


@pytest.mark.parametrize("by,order", [("dst", "csr"), ("dst", "csc"),
                                      ("src", "csr")])
@pytest.mark.parametrize("reduce", ["min", "max", "sum"])
@pytest.mark.parametrize("masked", [False, True])
def test_edge_map_reduce_matches_jax(pair, by, order, reduce, masked):
    jg, tg = pair
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(tg.n_edges).astype(np.float32)
    act = rng.random(tg.n_edges) < 0.3 if masked else None
    want = j2n(j_advance.edge_map_reduce(
        jg, jnp.asarray(vals), None if act is None else jnp.asarray(act),
        reduce, by, order))
    got = t2n(t_advance.edge_map_reduce(
        tg, torch.tensor(vals), None if act is None else torch.tensor(act),
        reduce, by, order))
    # a per-segment scatter sum in both: rounding order only
    _compare(got, want, reduce, "float", vals)


def test_edge_map_reduce_rejects_src_csc():
    g = t_sample.small_connected_graph(device="cpu")
    with pytest.raises(ValueError):
        t_advance.edge_map_reduce(g, g.values, None, "sum", "src", "csc")


@pytest.mark.parametrize("reduce", ["min", "max", "sum"])
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
@pytest.mark.parametrize("kind", ["float", "int", "ones"])
@pytest.mark.parametrize("edge_frontier", [False, True])
def test_advance_matches_jax(pair, reduce, direction, kind, edge_frontier):
    jg, tg = pair
    x, xi = _values(tg.n_vertices, 3)
    rng = np.random.default_rng(4)
    n = tg.n_edges if edge_frontier else tg.n_vertices
    front = rng.random(n) < 0.3
    jop = _ops(jnp, jnp.asarray(x), jnp.asarray(xi))[kind]
    top = _ops(torch, torch.tensor(x), torch.tensor(xi))[kind]
    jr, jt = j_ops.advance(jg, jnp.asarray(front), jop, reduce,
                           getattr(j_configs.AdvanceDirection, direction),
                           edge_frontier=edge_frontier)
    tr, tt = t_ops.advance(tg, torch.tensor(front), top, reduce,
                           getattr(t_configs.AdvanceDirection, direction),
                           edge_frontier=edge_frontier)
    np.testing.assert_array_equal(t2n(tt), j2n(jt))
    terms = j2n(jop(jg.edge_src, jg.col_indices, jnp.arange(jg.n_edges),
                    jg.values))
    _compare(t2n(tr), j2n(jr), reduce, kind, terms)


def test_advance_rejects_string_op_and_direction():
    g = t_sample.small_connected_graph(device="cpu")
    front = torch.ones(7, dtype=torch.bool)
    with pytest.raises(TypeError):
        t_ops.advance(g, front, "min_plus")
    with pytest.raises(ValueError):
        t_ops.advance(g, front, lambda s, d, e, w: w,
                      direction=t_configs.AdvanceDirection.OPTIMIZED)


# -- ops/advance.advance_semiring ----------------------------------------------------------

SEMIRINGS = ("plus_times", "min_plus", "max_times")
STRATEGIES = ("XLA_SEGMENT", "PALLAS_MERGE_PATH")


def _semiring_inputs(tg, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.random(tg.n_vertices).astype(np.float32) * 4
    x[rng.random(tg.n_vertices) < 0.05] = np.inf  # unreached distances
    return x, rng.random(tg.n_vertices) < 0.2


def _semiring_terms(jg, x, direction, semiring):
    """float64 |w * x| over the edges (the sums' atol), inf as 0."""
    xs = x[np.asarray(jg.csc_rows if direction == "FORWARD" else jg.col_indices)]
    w = np.asarray(jg.csc_values if direction == "FORWARD" else jg.values)
    return np.where(np.isfinite(xs), w.astype(np.float64) * xs, 0.0)


def _check_semiring(got, want, semiring, terms):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    if semiring == "plus_times":
        fin = np.isfinite(want)
        assert_sum_close(got[fin], want[fin], terms)
    else:
        assert_same(got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("direction", ["FORWARD", "BACKWARD"])
@pytest.mark.parametrize("with_frontier", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_advance_semiring_matches_jax(pair, semiring, direction, with_frontier,
                                      strategy):
    """Both strategies of both packages, W=128/C=128, inf positions
    included (x holds +inf at 5% of the vertices)."""
    jg, tg = pair
    x, front = _semiring_inputs(tg)
    if semiring != "min_plus":
        x = np.where(np.isinf(x), 1.0, x).astype(np.float32)
    f = front if with_frontier else None
    kw = dict(window=128, chunk=128)
    want = j2n(j_advance.advance_semiring(
        jg, jnp.asarray(x), semiring, None if f is None else jnp.asarray(f),
        getattr(j_configs.AdvanceDirection, direction),
        getattr(j_configs.LoadBalance, strategy), **kw))
    got = t2n(t_advance.advance_semiring(
        tg, torch.tensor(x), semiring,
        None if f is None else torch.tensor(f),
        getattr(t_configs.AdvanceDirection, direction),
        getattr(t_configs.LoadBalance, strategy), **kw))
    xa = x if f is None else np.where(f, x, 0.0)
    _check_semiring(got, want, semiring, _semiring_terms(jg, xa, direction,
                                                         semiring))


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("with_frontier", [False, True])
def test_advance_semiring_strategies_agree(semiring, with_frontier):
    """The port's two strategies on R-MAT 9 at the default W=2048/C=256,
    and the kernel path's layout is cached on the graph per pad value."""
    jg = _jax_graph("rmat9")
    tg = to_port(jg)
    x, front = _semiring_inputs(tg, 8)
    x = torch.tensor(x if semiring == "min_plus"
                         else np.where(np.isinf(x), 2.0, x).astype(np.float32))
    f = torch.tensor(front) if with_frontier else None
    D, L = t_configs.AdvanceDirection, t_configs.LoadBalance
    for d in (D.FORWARD, D.BACKWARD):
        a = t2n(t_advance.advance_semiring(tg, x, semiring, f, d, L.XLA_SEGMENT))
        b = t2n(t_advance.advance_semiring(tg, x, semiring, f, d,
                                           L.PALLAS_MERGE_PATH))
        xa = t2n(x) if f is None else np.where(front, t2n(x), 0.0)
        _check_semiring(b, a, semiring, _semiring_terms(jg, xa, d.name,
                                                        semiring))
    pads = {k[3] for k in tg.layouts}
    assert pads == ({3.0e38} if semiring == "min_plus" else {0.0})
    assert len(tg.layouts) == 2  # one pull and one push layout


def test_advance_semiring_empty_frontier_gives_identity():
    tg = t_sample.small_connected_graph(device="cpu")
    x = torch.arange(7, dtype=torch.float32)
    none = torch.zeros(7, dtype=torch.bool)
    for strategy in (t_configs.LoadBalance.XLA_SEGMENT,
                     t_configs.LoadBalance.PALLAS_MERGE_PATH):
        for semiring, ident in (("plus_times", 0.0), ("min_plus", np.inf),
                                ("max_times", 0.0)):
            y = t_advance.advance_semiring(tg, x, semiring, none,
                                           load_balance=strategy, window=128,
                                           chunk=128)
            assert (t2n(y) == ident).all()


def test_advance_semiring_rejects():
    g = t_sample.small_connected_graph(device="cpu")
    x = torch.zeros(7)
    with pytest.raises(ValueError):
        t_advance.advance_semiring(g, x, "plus_min")
    with pytest.raises(ValueError):
        t_advance.advance_semiring(
            g, x, "min_plus", direction=t_configs.AdvanceDirection.OPTIMIZED)


# -- ops/batch ------------------------------------------------------------------


@pytest.mark.parametrize("n,chunk", [(10, None), (10, 3), (10, 10), (7, 2),
                                     (1, 4)])
def test_batch_matches_jax(n, chunk):
    table = np.random.default_rng(10).random(16).astype(np.float32)
    tt, jt = torch.tensor(table), jnp.asarray(table)
    srcs = np.arange(n, dtype=np.int32) * 3 % 16

    def jfn(s):
        return {"row": jt * s, "pair": (jt[s], jnp.arange(4) + s)}

    def tfn(s):
        return {"row": tt * s, "pair": (tt[s], torch.arange(4) + s)}

    want = j_ops.batch(jfn, jnp.asarray(srcs), chunk)
    got = t_ops.batch(tfn, torch.tensor(srcs), chunk)
    np.testing.assert_allclose(t2n(got["row"]), j2n(want["row"]), rtol=1e-6)
    np.testing.assert_array_equal(t2n(got["pair"][0]), j2n(want["pair"][0]))
    np.testing.assert_array_equal(t2n(got["pair"][1]), j2n(want["pair"][1]))
    assert got["row"].shape == (n, 16)


def test_batch_runs_an_operator_per_source():
    """A one-level advance from each source, batched, equals the loop."""
    jg = _jax_graph("random40")
    tg = to_port(jg)
    ids = torch.arange(tg.n_vertices)

    def one_hop(s):
        front = ids == s
        y, touched = t_ops.advance(tg, front, lambda a, b, e, w: w, "min")
        return torch.where(touched, y, torch.inf)

    srcs = torch.tensor([0, 5, 9, 33, 39])
    got = t_ops.batch(one_hop, srcs, chunk_size=2)
    for k, s in enumerate(srcs.tolist()):
        assert torch.equal(got[k], one_hop(torch.tensor(s)))


def test_batch_under_vmap_refuses_host_reads():
    """vmap forbids .item() (as jax.vmap forbids Python control flow on
    traced values): batch raises and does not fall back to a loop."""
    with pytest.raises(RuntimeError):
        t_ops.batch(lambda s: torch.tensor(s.item()), torch.arange(4))
