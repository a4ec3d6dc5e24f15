"""The port's probe kernels (their plain versions, which the CPU runs)
against the TPU probes of ``benchmarks/`` in interpret mode, on the same
inputs:

- the dense pass's floor modes against ``probe_v5_floor.run_variant``
  (R-MAT 9, W=C=256), the JAX layout carried across array for array;
  rtol 1e-5 per reached row block (positive sums, only the order of the
  additions differs); blocks no chunk reaches are 0 in the port and
  unwritten by the TPU probe, so they are left out;
- the gather against ``probe_gather._build`` (lane, sublane, flat,
  twolevel), exactly, and against numpy's ``take_along_axis`` at
  ``probe_gather2``'s five shapes, that probe's own reference;
- the block copy against ``probe_dma.main``'s printed result, rtol 1e-6;

then the wrappers' shape, dtype and device errors, and the probe drivers
on the CPU.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gunrock_tpu.ops.pallas import semiring as jsemiring

from gunrock_tpu_torch.ops.kernels import _build, probes
from gunrock_tpu_torch.ops.kernels.layout import (
    DATA_FIELDS,
    META_FIELDS,
    BucketedEdges,
    build_bucketed_layout,
)
from gunrock_tpu_torch.ops.kernels.semiring import bucketed_semiring_spmv_plain
from gunrock_tpu_torch.probes import dma, gather as pgather, gather2 as pgather2, v5_floor

BENCHMARKS = Path(__file__).resolve().parent.parent / "benchmarks"


def load_probe(name):
    """A TPU probe module, loaded from its file (benchmarks/ is no
    package)."""
    spec = importlib.util.spec_from_file_location(name, BENCHMARKS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def carry(jl) -> BucketedEdges:
    return BucketedEdges.from_arrays(
        {k: np.asarray(getattr(jl, k)) for k in DATA_FIELDS},
        **{k: getattr(jl, k) for k in META_FIELDS}, device="cpu")


def jax_floor(monkeypatch, variant):
    """(output of probe_v5_floor.run_variant(variant, 9, 256, 256, 2) on
    its first x, the layout it built): its pallas_call in interpret mode,
    its outputs and layout captured."""
    probe = load_probe("probe_v5_floor")
    outs, layouts = [], []
    pallas_call, block, pull = pl.pallas_call, jax.block_until_ready, jsemiring.pull_layout
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: pallas_call(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda x: (outs.append(x), block(x))[1])
    monkeypatch.setattr(jsemiring, "pull_layout",
                        lambda *a, **k: (lambda l: (layouts.append(l), l)[1])(pull(*a, **k)))
    probe.run_variant(variant, 9, 256, 256, 2)
    return np.asarray(outs[0]), layouts[0]


@pytest.mark.parametrize("mode", ["dma", "gather"])
def test_floor_matches_jax_probe(monkeypatch, mode):
    want, jl = jax_floor(monkeypatch, mode)
    layout = carry(jl)
    x = np.random.default_rng(0).random(layout.n_vertices, dtype=np.float32)
    got = probes.spmv_floor(layout, torch.from_numpy(x), mode).numpy()
    assert got.shape == (layout.n_row_blocks, layout.window)
    want = want.reshape(layout.n_row_blocks, layout.window)
    reached = np.zeros(layout.n_row_blocks, bool)
    reached[layout.chunk_rb.numpy()] = True
    assert reached.any()
    np.testing.assert_allclose(got[reached], want[reached], rtol=1e-5, atol=0)
    assert (got > 0)[reached].all()
    assert (got[~reached] == 0).all()


def test_floor_gather_is_the_full_pass_summed():
    """The gather floor of a row block is 1e-30 times the sum of the full
    pass's outputs over the block's rows; blocks no chunk reaches are 0."""
    rng = np.random.default_rng(4)
    W, V = 128, 3 * 128
    rows = np.concatenate([rng.integers(0, W, 300), rng.integers(2 * W, V, 200)])
    cols = rng.integers(0, V, rows.size)
    vals = (rng.random(rows.size) + 0.1).astype(np.float32)
    layout = build_bucketed_layout(rows, cols, vals, V, window=W, chunk=64,
                                   device="cpu")
    x = torch.from_numpy(rng.random(V, dtype=np.float32))
    floor = probes.spmv_floor(layout, x, "gather")
    full = bucketed_semiring_spmv_plain(layout, x, "plus_times")
    sums = full.view(3, W).sum(1) * probes.FLOOR_SCALE
    torch.testing.assert_close(floor[:, 0], sums, rtol=1e-5, atol=0)
    assert (floor[1] == 0).all() and (floor == floor[:, :1]).all()
    stream = probes.spmv_floor(layout, x, "dma")
    block_vals = [vals[rows // W == b].sum() * 1e-30 for b in range(3)]
    np.testing.assert_allclose(stream[:, 0].numpy(), block_vals, rtol=1e-5)


@pytest.mark.parametrize("variant", ["lane", "sublane", "flat", "twolevel"])
def test_gather_matches_jax_probe(variant):
    out_j, ref = load_probe("probe_gather")._build(variant, interpret=True)
    x, idx, axis, want = pgather.inputs(variant)
    np.testing.assert_array_equal(want, ref)  # the same draws
    got = probes.gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out_j).reshape(got.shape))


@pytest.mark.parametrize("variant", pgather2.VARIANTS)
def test_gather_matches_take_along_axis_at_probe_gather2_shapes(variant):
    x, idx, axis = pgather2.inputs(variant)
    assert tuple(idx.shape) == pgather2.SHAPES[variant][0]
    got = probes.gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(x, idx, axis=axis))


def test_gather_bench_shape_and_flat_of_any_shape():
    x, idx, axis, want = pgather.inputs("bench")
    got = probes.gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), want)
    flat = probes.gather(torch.from_numpy(x), torch.from_numpy(idx[:2, :3, :5]
                                                                 .copy()), None)
    np.testing.assert_array_equal(flat.numpy(), x.reshape(-1)[idx[:2, :3, :5]])


def test_block_copy_matches_jax_probe(capsys):
    load_probe("probe_dma").main(interpret=True)
    words = capsys.readouterr().out.split()
    want = float(words[words.index("got") + 1])
    x, meta, cnt = dma.check_inputs()
    y = probes.block_copy_sum(*(torch.from_numpy(a) for a in (x, meta, cnt)))
    assert y.shape == (1, 8, 128) and bool((y == y[0, 0, 0]).all())
    np.testing.assert_allclose(float(y[0, 0, 0]), want, rtol=1e-6)


def test_block_copy_reads_cnt_not_meta_length():
    x = torch.arange(3 * 2 * 128, dtype=torch.float32).view(3, 2, 128)
    meta = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    y = probes.block_copy_sum(x, meta, torch.tensor([3], dtype=torch.int32))
    assert float(y[0, 0, 0]) == float(x[2].sum() * 2 + x[0].sum())
    assert y.shape == (1, 2, 128)


def test_wrapper_errors_and_counters():
    before = dict(_build.LAUNCHES)
    x = torch.zeros((8, 128))
    idx = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        probes.gather(x, idx.long(), 1)
    with pytest.raises(ValueError, match="float32"):
        probes.gather(x.double(), idx, 1)
    with pytest.raises(ValueError, match="agree"):
        probes.gather(x, torch.zeros((4, 128), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="1-3-D"):
        probes.gather(x.view(2, 4, 8, 16), idx.view(2, 4, 8, 16), 1)
    with pytest.raises(ValueError, match="no gather kernel for device meta"):
        probes.gather(x.to("meta"), idx.to("meta"), 1)
    with pytest.raises(ValueError, match=r"\[n_blocks, rows, 128\]"):
        probes.block_copy_sum(torch.zeros((2, 8, 64)), idx[0, :4], idx[0, :1])
    with pytest.raises(ValueError, match="cnt"):
        probes.block_copy_sum(torch.zeros((2, 8, 128)), idx[0, :4], idx[0, :2])
    with pytest.raises(ValueError, match="no block copy kernel for device meta"):
        probes.block_copy_sum(torch.zeros((2, 8, 128), device="meta"),
                              idx[0, :4].to("meta"), idx[0, :1].to("meta"))
    layout = build_bucketed_layout([0, 1], [1, 0], [1.0, 2.0], 2, window=128,
                                   chunk=64, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        probes.spmv_floor(layout, torch.ones(2), "full")
    with pytest.raises(ValueError, match="x must be"):
        probes.spmv_floor(layout, torch.ones(3), "dma")
    empty = build_bucketed_layout([], [], [], 5, window=128, chunk=64, device="cpu")
    assert (probes.spmv_floor(empty, torch.ones(5), "gather") == 0).all()
    # CPU calls run the plain versions and count no launch
    probes.gather(x, idx, 1)
    probes.spmv_floor(layout, torch.ones(2), "dma")
    assert dict(_build.LAUNCHES) == before
    assert "probes" in _build.SOURCES
    text = (_build.CSRC / "probes.cu").read_text()
    assert "GR_IN_RANGE" in text and "cp.async.bulk" in text and "mbarrier" in text


def _json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_v5_floor_driver_prints_the_jax_keys(capsys):
    assert v5_floor.main(["all", "--scale", "8", "--num_runs", "2",
                          "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    keys = {"probe", "variant", "scale", "window", "chunk", "n_chunks",
            "avg_ms", "gedges_per_s", "gbps_blocks"}
    assert [r["variant"] for r in lines[:3]] == ["dma", "gather", "full"]
    for r in lines[:3]:
        assert keys <= set(r) and r["device"] == "cpu, not measured"
        assert r["device_ms"] == "not measured"
    split = lines[3]
    assert split["probe"] == "v5_floor_split" and "bound_ms" not in split
    assert split["scatter_ms"] == lines[2]["avg_ms"] - lines[1]["avg_ms"]


@pytest.mark.parametrize("module,n", [(pgather, 5), (pgather2, 5)])
def test_gather_drivers_check_every_variant(capsys, module, n):
    assert module.main(["all", "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == n and all(r["ok"] for r in lines)
    bench = [r for r in lines if "gelems_per_s" in r]
    assert bench and all(r["device_ms"] == "not measured" for r in bench)


def test_dma_driver_check_and_bench(capsys):
    assert dma.main(["all", "--scale", "8", "--num_runs", "2",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "MATCH" in out and "MISMATCH" not in out
    check, bench = _json_lines(out)
    assert check["got"] == 35643392.0
    assert bench["block_bytes"] == 2048 * 4 and bench["copies"] > 0
    assert bench["device_ms"] == bench["yardstick_device_ms"] == "not measured"
    assert bench["gbps"] > 0 and "pct_peak_bw" not in bench
