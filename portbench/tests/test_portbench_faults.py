"""A run with the timed path broken underneath comes out not correct.

Each test plants one fault in the port (monkeypatched, on the CPU at a
small size) and drives the rest of a run, everything but the look for a
card: a search step that returns its state unchanged, half of a batch
left out, an answer altered where it is produced. The cells run on one
card, so no exchange between cards can be left out."""

import pytest
import torch

from conftest import small_configs
from portbench import manifest
from portbench.cell import Cell

import gunrock_tpu_torch.algorithms.bfs as bfs_mod
import gunrock_tpu_torch.algorithms.sssp as sssp_mod
import gunrock_tpu_torch.experimental.async_sweep as async_mod


def _run(cell_name):
    import sys

    sys.path.insert(0, str(manifest.HERE))
    try:
        import run
    finally:
        sys.path.remove(str(manifest.HERE))
    cell = Cell(cell_name, 2**31 + 99, "cpu",
                config=small_configs()[cell_name])
    result, _ = run.measure(cell, 0.1, False)
    return result


def _unchanged_bfs(monkeypatch):
    monkeypatch.setattr(bfs_mod, "bfs_push_step",
                        lambda g, front, dist, it, budget:
                        (torch.zeros_like(front), dist))
    monkeypatch.setattr(bfs_mod, "_pull",
                        lambda lay, front, dist, it:
                        (torch.zeros_like(front), dist))


def _unchanged_sssp(monkeypatch):
    monkeypatch.setattr(sssp_mod, "sssp_push_step",
                        lambda g, front, dist, budget:
                        (torch.zeros_like(front), dist))
    monkeypatch.setattr(sssp_mod, "_pull",
                        lambda lay, front, dist:
                        (torch.zeros_like(front), dist))


def _unchanged_msbfs(monkeypatch):
    monkeypatch.setattr(bfs_mod, "bucketed_spmm",
                        lambda lay, x, exact=True: torch.zeros_like(x))


def _unchanged_async(monkeypatch):
    monkeypatch.setattr(async_mod, "gs_sweep_min",
                        lambda *a: (a[5].clone(), 1, 1))


def _half_batch(monkeypatch):
    real = bfs_mod.msbfs_kernel

    def half(graph, sources, **kw):
        k = len(sources)
        dist, depth = real(graph, sources[: k // 2], **kw)
        return torch.cat([dist, dist[:, : k - k // 2]], dim=1), depth

    monkeypatch.setattr(bfs_mod, "msbfs_kernel", half)


def _altered(module, fn_name, field):
    def plant(monkeypatch):
        real = getattr(module, fn_name)

        def altered(*a, **kw):
            out = real(*a, **kw)
            d = getattr(out, field) if field else out[0]
            far = torch.nonzero(torch.isfinite(d.float())
                                & (d.float() < 2**30)).flatten()[-1]
            d[far] += 1
            return out

        monkeypatch.setattr(module, fn_name, altered)
    return plant


FAULTS = [
    ("kron-g500-s20.bfs", "unchanged", _unchanged_bfs),
    ("kron-g500-s20.bfs", "altered", _altered(bfs_mod, "run", "distances")),
    ("kron-g500-s20.sssp", "unchanged", _unchanged_sssp),
    ("kron-g500-s20.sssp", "altered", _altered(sssp_mod, "run", "distances")),
    ("kron-g500-s20.bfs-k32", "unchanged", _unchanged_msbfs),
    ("kron-g500-s20.bfs-k32", "half_batch", _half_batch),
    ("kron-g500-s20.bfs-k32", "altered",
     _altered(bfs_mod, "msbfs_kernel", None)),
    ("delaunay-n20.sssp-async", "unchanged", _unchanged_async),
    ("delaunay-n20.sssp-async", "altered",
     _altered(async_mod, "sssp_async", None)),
]


def test_the_sound_program_is_correct():
    for cell in {c for c, _, _ in FAULTS}:
        assert _run(cell)["correct"], cell


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_planted_fault_is_not_correct(monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    result = _run(cell)
    assert result["correct"] is False, (cell, fault, result)
