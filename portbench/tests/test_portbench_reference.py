"""The reference and the checks against graphs worked by hand."""

from types import SimpleNamespace

import numpy as np
import torch

from portbench import check, manifest
from portbench.graphs import EdgeList
from portbench.reference import search

BFS, MSBFS, SSSP = (manifest.kind(k) for k in ("bfs", "msbfs", "sssp"))
WITH_PRED = SimpleNamespace(PREDECESSORS=True)
NO_PRED = SimpleNamespace(PREDECESSORS=False)


def _graph(n, pairs, weights=None):
    """Symmetric EdgeList of undirected ``pairs`` (u, v[, w])."""
    rows, cols, ws = [], [], []
    for i, (u, v) in enumerate(pairs):
        w = 1.0 if weights is None else weights[i]
        rows += [u, v]
        cols += [v, u]
        ws += [w, w]
    order = np.lexsort((cols, rows))
    return EdgeList(n, np.array(rows, np.int32)[order],
                    np.array(cols, np.int32)[order],
                    np.array(ws, np.float32)[order])


# 0-1-2-3 path, 0-4 edge, 1-4 edge; 5-6 apart; 7 isolated
PAIRS = [(0, 1), (1, 2), (2, 3), (0, 4), (1, 4), (5, 6)]
W = [0.5, 0.25, 1.0, 1.0, 0.125, 0.75]


def _csr(weights=None):
    return search.Csr.from_edges(_graph(8, PAIRS, weights), "cpu")


def test_bfs_by_hand():
    d = search.bfs(_csr(), 0)
    assert d.tolist() == [0, 1, 2, 3, 1, -1, -1, -1]
    assert search.bfs_parents(_csr(), d).tolist() == \
        [-1, 0, 1, 2, 0, -1, -1, -1]
    assert search.bfs(_csr(), 5).tolist() == [-1] * 5 + [0, 1, -1]


def test_bellman_ford_by_hand():
    csr = _csr(W)
    d = search.bellman_ford(csr, 0)
    # 0->1 0.5; 0->1->4 0.625 < 0->4 1.0; 0->1->2 0.75; then 2->3 1.75
    assert d.tolist()[:5] == [0.0, 0.5, 0.75, 1.75, 0.625]
    assert all(np.isinf(d.tolist()[5:]))
    assert search.sssp_parents(csr, d).tolist() == \
        [-1, 0, 1, 2, 1, -1, -1, -1]


def test_check_bfs_accepts_the_answer_and_counts_faults():
    csr = _csr()
    d = torch.tensor([0, 1, 2, 3, 1, -1, -1, -1])
    p = torch.tensor([-1, 0, 1, 2, 0, -1, -1, -1])
    assert BFS.check_answer(csr, [0], {"dist": d, "pred": p}) == \
        {"dist_mismatch": 0, "pred_invalid": 0}
    # 4's parent may be 0 only: 1 is as far from the source as 4 is
    bad = p.clone()
    bad[4] = 1
    assert BFS.check_answer(csr, [0], {"dist": d, "pred": bad}) == \
        {"dist_mismatch": 0, "pred_invalid": 1}
    # 3's parent is no neighbour; the source has a parent
    bad = p.clone()
    bad[3], bad[0] = 0, 4
    assert BFS.check_answer(csr, [0], {"dist": d, "pred": bad}) == \
        {"dist_mismatch": 0, "pred_invalid": 2}
    d2 = d.clone()
    d2[3] = -1
    assert BFS.check_answer(csr, [0], {"dist": d2, "pred": p})[
        "dist_mismatch"] == 1


def test_check_sssp_readings():
    csr = _csr(W)
    ref = search.bellman_ford(csr, 0).float()
    pred = search.sssp_parents(csr, ref.double())
    r = SSSP.check_answer(csr, [0], {"dist": ref, "pred": pred})
    assert r == {"reach_mismatch": 0, "dist_rel_err": 0.0, "pred_gap": 0.0,
                 "pred_invalid": 0}
    off = ref.clone()
    off[3] = 1.75 * (1 + 1e-3)
    assert abs(SSSP.check_answer(csr, [0], {"dist": off})["dist_rel_err"]
               - 1e-3) < 1e-6
    # 4 through 0 directly: a valid edge, 1.0 against 0.625
    p2 = pred.clone()
    p2[4] = 0
    r = SSSP.check_answer(csr, [0], {"dist": ref, "pred": p2})
    assert abs(r["pred_gap"] - 0.6) < 1e-9 and r["pred_invalid"] == 0
    gone = ref.clone()
    gone[2] = float("inf")
    assert SSSP.check_answer(csr, [0], {"dist": gone})["reach_mismatch"] == 1
    nan = ref.clone()
    nan[2] = float("nan")
    assert SSSP.check_answer(csr, [0], {"dist": nan})["reach_mismatch"] == 1


def test_check_msbfs_all_columns():
    csr = _csr()
    d = torch.stack([search.bfs(csr, 0), search.bfs(csr, 5)], dim=1)
    assert MSBFS.check_answer(csr, [0, 5], {"dist": d}) == {"dist_mismatch": 0}
    d[6, 1] = 2
    assert MSBFS.check_answer(csr, [0, 5], {"dist": d}) == {"dist_mismatch": 1}
    assert MSBFS.check_answer(csr, [0, 5], {"dist": d[:, :1]}) == \
        {"dist_mismatch": 16}


def test_controls_fail_their_checks():
    csr = _csr(W)
    r = BFS.check_answer(csr, [0], BFS.control(csr, [0], WITH_PRED))
    assert r["dist_mismatch"] == 1  # vertex 3, the last level
    r = MSBFS.check_answer(csr, [0, 5], MSBFS.control(csr, [0, 5], NO_PRED))
    assert r["dist_mismatch"] == 2
    # a long path of small weights: bfloat16's 8 bits lose the sum
    n = 400
    chain = _graph(n, [(i, i + 1) for i in range(n - 1)],
                   [0.01 + 0.001 * (i % 7) for i in range(n - 1)])
    c = search.Csr.from_edges(chain, "cpu")
    r = SSSP.check_answer(c, [0], SSSP.control(c, [0], WITH_PRED))
    assert r["dist_rel_err"] > 1e-2 and r["pred_invalid"] == 0


def test_merge_and_judge():
    m = check.merge([{"a": 1, "e": 0.5}, {"a": 2, "e": 0.25}])
    assert m == {"a": 3, "e": 0.5}
    ok, table = check.judge(m, {"a": 3, "e": 1.0})
    assert ok and table["e"] == {"value": 0.5, "limit": 1.0}
    assert not check.judge(m, {"a": 2, "e": 1.0})[0]
    assert not check.judge(m, {"a": 3})[0]  # a reading with no limit
    assert not check.judge({"e": float("nan")}, {"e": 1.0})[0]
