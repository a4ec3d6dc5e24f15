"""The multi-source BFS kernels (``csrc/msbfs.cu``) on the card against
their plain versions on the same CUDA tensors: the start and every level
of a search bit for bit (words, distances, counters), in the normal and
the checked build, at K = 32 and K = 40 (a second, partial word), on a
degree-sorted undirected R-MAT graph of scale 16 whose hubs' runs pass the
block threshold, on ``probes/predecessor_cases.py``'s planted hub (a run
of several block rounds) and on a six-vertex graph with no hub block; the
whole search (``msbfs_kernel``) against the CPU port's, distances, depth
and the query span's ``slots``; and one launch a level.

Marked ``card``: each skips without a CUDA device. The file imports no
JAX, so that on the card it runs without the test tree's configuration:

    python -m pytest tests/test_torch_msbfs_card.py --noconftest -q
"""

import re

import numpy as np
import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs
from gunrock_tpu_torch.formats import Coo
from gunrock_tpu_torch.graph import GraphProperties, build_graph
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels import msbfs as M
from gunrock_tpu_torch.probes import predecessor_cases
from gunrock_tpu_torch.utils import profiler

KS = [32, 40]
BLOCK_RUN = int(re.search(r"constexpr int kBlockRun = (\d+);",
                          (_build.CSRC / "msbfs.cu").read_text()).group(1))


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graphs(card):
    kron, _ = degree_sort(rmat_graph(16, 16, seed=3, undirected=True,
                                     device=card))
    assert int(torch.diff(kron.csc_offsets).max()) > BLOCK_RUN
    src = np.array([0, 0, 1, 2, 3, 5], np.int32)
    dst = np.array([1, 2, 3, 3, 4, 4], np.int32)
    tiny = build_graph(Coo(6, 6, src, dst, np.ones(6, np.float32)),
                       GraphProperties(directed=True, weighted=False), card)
    return {"kron": kron, "hub": predecessor_cases.hub_graph(card)[0],
            "tiny": tiny}


def _sources(g, K: int, seed: int) -> torch.Tensor:
    """K sources: random vertices of nonzero degree, one of them twice,
    and a vertex of no out-edge where there is one."""
    deg = g.out_degrees().cpu()
    gen = torch.Generator().manual_seed(seed)
    live = torch.nonzero(deg > 0).flatten()
    s = live[torch.randint(live.numel(), (K,), generator=gen)]
    s[1] = s[0]
    dead = torch.nonzero(deg == 0).flatten()
    if dead.numel():
        s[2] = dead[0]
    return s.to(g.device)


@pytest.fixture(params=[False, True], ids=["normal", "checked"])
def build(request):
    _build.use_checked(request.param)
    yield request.param
    _build.use_checked(False)


def _equal(got, want, what: str) -> None:
    for name, a in got.tensors().items():
        assert torch.equal(a, getattr(want, name)), f"{what}: {name} differs"


@pytest.mark.card
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("name", ["kron", "hub", "tiny"])
def test_each_level_equals_plain(graphs, build, name, K):
    g = graphs[name]
    src = _sources(g, K, K)
    got, want = (M.MsbfsState.empty(g.n_vertices, K, g.device)
                 for _ in range(2))
    M.msbfs_start(g, src, got)
    M.msbfs_start_plain(g, src, want)
    torch.cuda.synchronize()
    _equal(got, want, "start")
    level = 0
    while int(want.counts[level % 2]) > 0:
        M.msbfs_pull(g, got, level)
        M.msbfs_pull_plain(g, want, level)
        torch.cuda.synchronize()
        _equal(got, want, f"level {level}")
        level += 1
    assert level > 2


@pytest.mark.card
@pytest.mark.parametrize("K", KS)
def test_search_equals_the_cpu_port(graphs, K):
    g = graphs["kron"]
    src = _sources(g, K, 100 + K)
    cpu = g.to("cpu")
    with profiler.recording() as rec:
        d, depth = bfs.msbfs_kernel(g, src)
    want, want_depth = bfs.msbfs_kernel(cpu, src.cpu())
    with profiler.recording() as cpu_rec:
        bfs.msbfs_kernel(cpu, src.cpu())
    assert torch.equal(d.cpu(), want) and depth == want_depth
    assert rec.spans[0].attrs["slots"] == cpu_rec.spans[0].attrs["slots"]
    assert 0 < rec.spans[0].attrs["scan_share"] < 1


@pytest.mark.card
def test_one_launch_a_level(graphs):
    g = graphs["kron"]
    before = dict(_build.LAUNCHES)
    _, depth = bfs.msbfs_kernel(g, _sources(g, 32, 7))
    assert _build.LAUNCHES["msbfs_pull"] - before.get("msbfs_pull", 0) == depth
    assert _build.LAUNCHES["msbfs_start"] - before.get("msbfs_start", 0) == 1
