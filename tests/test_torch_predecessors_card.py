"""The predecessor kernel (``csrc/predecessors.cu``) on the card against
its plain version on the same CUDA tensors: ``torch.equal`` on ``pred``
for BFS and SSSP, in the normal and the checked build, on
``probes/predecessor_cases.py``'s graphs (a hub run past the block
threshold with the source mid-run, a directed graph, unreached and
isolated vertices, exact ties, distances at the edge of ``isclose``'s
tolerance) and on searches of a degree-sorted undirected R-MAT graph of
scale 16; and one launch counted a ``run``.

Marked ``card``: each skips without a CUDA device. The file imports no
JAX, so that on the card it runs without the test tree's configuration:

    python -m pytest tests/test_torch_predecessors_card.py --noconftest -q
"""

import pytest
import torch

from gunrock_tpu_torch.algorithms import bfs, sssp
from gunrock_tpu_torch.graph.reorder import degree_sort
from gunrock_tpu_torch.io.generators import rmat_graph
from gunrock_tpu_torch.ops.kernels import _build
from gunrock_tpu_torch.ops.kernels import predecessors as P
from gunrock_tpu_torch.probes import predecessor_cases

CASES = ["hub_mid.bfs", "hub_mid.sssp", "directed.bfs", "directed.sssp",
         "unreached.bfs", "unreached.sssp", "ties.sssp", "tolerance.sssp"]
KERNELS = {"bfs": P.bfs_predecessors, "sssp": P.sssp_predecessors}


@pytest.fixture(scope="module")
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cases(card):
    return predecessor_cases.cases(card)


@pytest.fixture(scope="module")
def kron(card):
    """A degree-sorted undirected R-MAT graph (scale 16, edge factor 16)
    and four sources of nonzero degree."""
    g, _ = degree_sort(rmat_graph(16, 16, seed=3, undirected=True,
                                  device=card))
    gen = torch.Generator().manual_seed(7)
    live = torch.nonzero(g.out_degrees().cpu() > 0).flatten()
    return g, live[torch.randperm(live.numel(), generator=gen)[:4]].tolist()


@pytest.fixture(params=[False, True], ids=["normal", "checked"])
def build(request):
    _build.use_checked(request.param)
    yield request.param
    _build.use_checked(False)


@pytest.mark.card
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain(cases, build, name):
    g, kind, d = cases[name]
    got = KERNELS[kind](g, d)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device == d.device
    assert torch.equal(got, P.predecessors_plain(g, d, kind))


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_kernel_equals_plain_on_searches(kron, build, kind):
    g, sources = kron
    for s in sources:
        if kind == "bfs":
            d = bfs.bfs_kernel_do(g, s)[0]
        else:
            d = sssp.sssp_kernel_do(g, s)[0]
        got = KERNELS[kind](g, d)
        torch.cuda.synchronize()
        assert torch.equal(got, P.predecessors_plain(g, d, kind))


@pytest.mark.card
def test_tolerance_case_straddles_the_edge_on_the_card(cases):
    """On the card, torch.isclose finds the crafted in-edges inside the
    tolerance for some targets and outside for others, as on the CPU."""
    g, _, d = cases["tolerance.sssp"]
    ok = P.tight_slots(g, d, "sssp")
    cpu = g.to("cpu")
    assert torch.equal(ok.cpu(), P.tight_slots(cpu, d.cpu(), "sssp"))
    pred = P.predecessors_plain(g, d, "sssp")
    targets = torch.arange(1, 1600, 2, device=d.device)
    assert (pred[targets] >= 0).any() and (pred[targets] == -1).any()


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_one_launch_a_run(cases, kind):
    g = cases[f"hub_mid.{kind}"][0]
    run = bfs.run if kind == "bfs" else sssp.run
    name = f"{kind}_predecessors"
    for s in (0, 5, 17):
        before = _build.LAUNCHES[name]
        res = run(g, s, warmup=False, device=g.device)
        assert _build.LAUNCHES[name] == before + 1
        assert torch.equal(res.predecessors,
                           P.predecessors_plain(g, res.distances, kind))
