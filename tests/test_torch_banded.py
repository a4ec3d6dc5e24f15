"""The banded gather, B10: a numpy model of the CUDA kernel's schedule
(``csrc/banded.cu``) against the port's plain version and the JAX
package's Pallas kernel in interpret mode, at the edge shapes of
``probes/banded_cases.py``; those shapes themselves; the real slab of the
slabbed triangle count; and the pull probe's ``--banded`` lines.

Everything is compared exactly: a gather moves int32 values and does no
arithmetic on them."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.ops.pallas.banded import banded_gather as j_banded

from gunrock_tpu_torch.algorithms import tc
from gunrock_tpu_torch.ops.kernels.banded import (
    banded_gather,
    banded_gather_plain,
)
from gunrock_tpu_torch.probes import banded_cases as bc
from gunrock_tpu_torch.probes.v5_floor import probe_graph

SOURCE = (Path(__file__).resolve().parent.parent / "gunrock_tpu_torch" / "csrc"
          / "banded.cu")

# csrc/banded.cu's kBandThreads, kVecs and kVecWidth
THREADS, VECS, VEC_WIDTH = 256, 2, 4
UNWRITTEN = -(1 << 40)  # no int32 value


def model_banded(table2, idx, block_lo, span_rows: int, block_t: int,
                 grid: int, vec: bool):
    """(out, writes) of the kernel's schedule: ``grid`` thread blocks
    (the launcher's min(index blocks, resident blocks)), block b walking
    index blocks g = b, b + grid, ...; in each, its THREADS threads take
    items i0 = thread, += VECS * THREADS, and at each i0 load the VECS
    items i0 + u * THREADS (16-byte vectors of VEC_WIDTH ints in the
    aligned instance ``vec``, single ints in the scalar one) before
    reading the window's start; a block whose window does not fit the
    table stops there and writes nothing; else every loaded element is
    gathered from its clamped window position and stored. ``writes``
    counts the stores of each position."""
    tab = table2.reshape(-1).astype(np.int64)
    ix = idx.astype(np.int64)
    n_blocks = ix.size // block_t
    span = span_rows * 128
    width = VEC_WIDTH if vec else 1
    n_items = block_t // width
    out = np.full(ix.size, UNWRITTEN, np.int64)
    writes = np.zeros(ix.size, np.int64)
    # items of one i0 step, in load order: u-major, then thread
    step_items = (np.arange(VECS)[:, None] * THREADS
                  + np.arange(THREADS)[None, :]).ravel()
    for b in range(min(grid, n_blocks)):
        for g in range(b, n_blocks, min(grid, n_blocks)):
            base = g * block_t
            for i0 in range(0, n_items, VECS * THREADS):
                items = i0 + step_items
                items = items[items < n_items]
                pos = base + items[:, None] * width + np.arange(width)
                x = ix[pos]  # every load of the step first
                lo = int(block_lo[g]) * 128
                if not (0 <= lo and lo + span - 1 < tab.size):
                    break
                out[pos] = tab[lo + np.clip(x - lo, 0, span - 1)]
                np.add.at(writes, pos.ravel(), 1)
    return out, writes


def _vector_instance(idx: torch.Tensor, block_t: int) -> bool:
    """The launcher's choice: the aligned instance where idx (and out, a
    fresh allocation) allow 16-byte accesses and block_t holds whole
    vectors."""
    return block_t % VEC_WIDTH == 0 and idx.data_ptr() % 16 == 0


def _cases() -> dict:
    cases = dict(bc.edge_cases("cpu"))
    gen = torch.Generator().manual_seed(5)
    cases["random_t2048_span37"] = bc.banded_case(
        gen, 40_000, 5, 2048, 37, "cpu") + (2048, 37)
    cases["random_t256_span5"] = bc.banded_case(
        gen, 5_000, 9, 256, 5, "cpu") + (256, 5)
    return cases


CASES = _cases()
_JAX = {}


def _jax(name):
    if name not in _JAX:
        table2, idx, block_lo, block_t, span_rows = CASES[name]
        _JAX[name] = np.asarray(j_banded(
            jnp.asarray(table2.numpy()), jnp.asarray(idx.numpy()),
            jnp.asarray(block_lo.numpy()), span_rows=span_rows,
            block_t=block_t, interpret=True))
    return _JAX[name]


@pytest.mark.parametrize("grid", [1, 3, 132 * 8])
@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_plain_and_jax(name, grid):
    """The kernel's schedule at a grid of 1, 3 and a full H100's 1,056
    blocks (8 of 256 threads an SM) writes every position once, equal to the plain version, the
    wrapper's CPU path and the JAX kernel in interpret mode."""
    table2, idx, block_lo, block_t, span_rows = CASES[name]
    out, writes = model_banded(table2.numpy(), idx.numpy(), block_lo.numpy(),
                               span_rows, block_t, grid,
                               _vector_instance(idx, block_t))
    assert (writes == 1).all()
    plain = banded_gather_plain(table2, idx, block_lo, span_rows=span_rows,
                                block_t=block_t).numpy()
    np.testing.assert_array_equal(out, plain)
    np.testing.assert_array_equal(
        banded_gather(table2, idx, block_lo, span_rows=span_rows,
                      block_t=block_t).numpy(), plain)
    np.testing.assert_array_equal(plain, _jax(name))


def test_model_constants_are_the_kernels():
    """The model's thread count, vectors a thread and vector width are the
    ones ``csrc/banded.cu`` declares."""
    text = SOURCE.read_text()
    declared = {k: int(v) for k, v in re.findall(
        r"constexpr int (kBandThreads|kVecs|kVecWidth) = (\d+);", text)}
    assert declared == {"kBandThreads": THREADS, "kVecs": VECS,
                        "kVecWidth": VEC_WIDTH}
    assert VEC_WIDTH * 4 == 16  # int4: one 16-byte access
    assert "__ldcs" in text and "__stcs" in text


def test_model_instances_and_unfit_blocks():
    """The unaligned edge case takes the scalar instance and the others
    the vector one; a block whose window does not fit writes nothing,
    the other blocks all of theirs."""
    for name, (_, idx, _, block_t, _) in CASES.items():
        assert _vector_instance(idx, block_t) == (name != "unaligned"), name
    table2, idx, block_lo, block_t, span_rows = CASES["one_block"]
    bad = torch.cat([block_lo, torch.tensor([table2.shape[0]],
                                            dtype=torch.int32)])
    idx2 = torch.cat([idx, idx])
    for vec in (True, False):
        out, writes = model_banded(table2.numpy(), idx2.numpy(), bad.numpy(),
                                   span_rows, block_t, 2, vec)
        assert (writes[:block_t] == 1).all() and not writes[block_t:].any()
        assert (out[block_t:] == UNWRITTEN).all()


def test_edge_cases_have_their_shapes():
    """Each edge case is what its name says, and every window fits."""
    assert max(bc.SYNTH_SPANS) == tc.MAX_SPAN_ROWS
    i32 = np.iinfo(np.int32)
    for name, (table2, idx, block_lo, block_t, span_rows) in CASES.items():
        n_rows = table2.shape[0]
        lo_rows = block_lo.numpy().astype(np.int64)
        assert idx.numel() % block_t == 0 and block_t % 128 == 0
        assert ((lo_rows >= 0) & (lo_rows + span_rows <= n_rows)).all(), name
        lo = np.repeat(lo_rows * 128, block_t)
        x = idx.numpy().astype(np.int64)
        below, above = x < lo, x >= lo + span_rows * 128
        if name == "clamp":
            assert not (~below & ~above).any() and below.any() and above.any()
            assert {i32.min, i32.max} <= set(x[:block_t].tolist())
            assert lo_rows[0] == 0
        elif name == "last_rows":
            assert (lo_rows == n_rows - span_rows).all()
            assert (x[-block_t:] >= table2.numel()).all()
        else:
            assert 0.8 < (~below & ~above).mean() < 1.0, name
    assert CASES["span1"][4] == 1 and CASES["span200"][4] == tc.MAX_SPAN_ROWS
    assert CASES["one_block"][1].numel() == CASES["one_block"][3]
    assert CASES["t128"][3] == 128


def test_real_slab_is_what_the_triangle_count_gathers():
    """The captured slab is the first of the slabbed count's: its windows
    fit, every position lies in its window (so ``index_select`` of the
    read positions is the same gather), and it is the slab's size."""
    graph = probe_graph(8, "cpu")
    table2, idx, block_lo, block_t, span_rows = bc.real_slab(graph)
    rk = tc.ranked_dag(graph)
    slab = -(-min(-(-rk["n_wedges"] // bc.TC_SLABS), rk["n_wedges"])
             // block_t) * block_t
    assert idx.numel() == slab and block_t == tc.BLOCK_T
    assert span_rows == tc.span_rows_for(rk["max_deg"])
    assert torch.equal(bc.read_indices(idx, block_lo, span_rows, block_t),
                       idx)
    assert torch.equal(table2.view(-1).index_select(0, idx),
                       banded_gather_plain(table2, idx, block_lo,
                                           span_rows=span_rows,
                                           block_t=block_t))
    assert bc.bound_bytes(idx, block_lo) == (
        8 * idx.numel() + 4 * block_lo.numel()
        + 4 * (int(idx.max()) - int(idx.min()) + 1))


def test_pull_probe_banded_lines(monkeypatch, capsys):
    """``probes/pull.py --banded`` on the CPU (synthetic slabs cut down):
    one line per slab with the kernel's and ``index_select``'s times, no
    device time or bound off the card, and the triangle count's line."""
    import json

    from gunrock_tpu_torch.probes import pull

    monkeypatch.setattr(bc, "SYNTH_BLOCKS", 3)
    monkeypatch.setattr(bc, "SYNTH_TABLE", 30_000)
    assert pull.main(["--scale", "8", "--device", "cpu", "--num_runs", "1",
                      "--banded"]) == 0
    rows = {r["case"]: r for r in map(json.loads,
                                      capsys.readouterr().out.splitlines())}
    slabs = ["banded_real", "banded_real_unaligned",
             *(f"banded_span{r}" for r in bc.SYNTH_SPANS)]
    assert list(rows) == [*slabs, "banded_tc"]
    for name in slabs:
        row = rows[name]
        assert row["ms"] > 0 and row["index_select_ms"] > 0
        assert row["device_ms"] == row["share_of_bound"] == "not measured"
        assert row["index_select_device_ms"] == "not measured"
        assert "bound_ms" not in row  # the card's peaks only
        assert row["aligned"] == (name != "banded_real_unaligned")
        assert row["device"] == rows["banded_tc"]["device"]
    for r in bc.SYNTH_SPANS:
        assert rows[f"banded_span{r}"]["span_rows"] == r
        assert rows[f"banded_span{r}"]["positions"] == 3 * tc.BLOCK_T
    assert rows["banded_real"]["positions"] == rows[
        "banded_real_unaligned"]["positions"]
    tc_row = rows["banded_tc"]
    assert tc_row["slabs"] == bc.TC_SLABS
    assert len(tc_row["ms"]) == len(tc_row["slabbed_ms"]) == 3
