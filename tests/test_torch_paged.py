"""The port's bucketed kernels (their plain versions, which the CPU runs)
against the JAX package's paged and snake-order twins in interpret mode.

The JAX package pages its chunk metadata (``ops/pallas/paged.py``) once a
layout outgrows the TPU's scalar-memory budget, and has a snake-order
variant of the dense pass; each of those kernels computes the contract of
a bucketed kernel over the same edges. The port has no such budget and
one layout, so its bucketed kernels are the counterparts of both forms.
Here a small layout is forced to paged (``build_paged_layout(window=128,
chunk=256, page=8)``) or snake order, and the port runs the same edges
through its own layout at the same W/C.

Tolerances as for the bucketed twins (``test_torch_kernels.py``): max/min
exact, 0/1 and signed one-hot inputs exact, float plus_times rtol 1e-4
(the JAX kernels rebuild f32 from a bf16 hi+lo split). With ``out_mask``
only the rows inside it are compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gunrock_tpu.ops.pallas import paged as jpaged

from gunrock_tpu_torch.ops.kernels.layout import build_bucketed_layout
from gunrock_tpu_torch.ops.kernels.semiring import (
    bucketed_semiring_spmv,
    bucketed_semiring_spmv_sparse,
    bucketed_semiring_spmv_sparse_minmax,
)
from gunrock_tpu_torch.ops.kernels.spmm import bucketed_spmm, bucketed_spmm_sparse

V, W, C, PAGE = 700, 128, 256, 8
_BIG = 3.0e38


def _edges(seed=90):
    rng = np.random.default_rng(seed)
    n = 9000
    rows = (V * rng.random(n) ** 2).astype(np.int32)
    cols = rng.integers(0, V, n).astype(np.int32)
    key = np.unique(rows.astype(np.int64) * V + cols)
    rows, cols = (key // V).astype(np.int32), (key % V).astype(np.int32)
    return rows, cols, (rng.random(key.size) + 0.1).astype(np.float32)


def _layouts(pad=0.0, snake=False, binary=False):
    """(JAX paged or snake layout, the port's layout) of the same edges;
    ``binary`` makes the values 0/1 (coloring's ``higher`` predicate)."""
    rows, cols, vals = _edges()
    if binary:
        vals = (vals > 0.6).astype(np.float32)
    if snake:
        jl = jpaged.build_snake_layout(rows, cols, vals, V, window=W, chunk=C,
                                       page=PAGE, group=4, pad_value=pad)
    else:
        jl = jpaged.build_paged_layout(rows, cols, vals, V, window=W, chunk=C,
                                       page=PAGE, pad_value=pad)
    tl = build_bucketed_layout(rows, cols, vals, V, window=W, chunk=C,
                               pad_value=pad, device="cpu")
    return jl, tl


def _masks(rng):
    act = rng.random(V) < 0.3
    om = rng.random(V) < 0.5
    return act, om


def _dense(semiring, snake):
    pad = _BIG if semiring == "min_plus" else 0.0
    jl, tl = _layouts(pad, snake)
    x = np.random.default_rng(1).random(V).astype(np.float32)
    fn = jpaged.snake_semiring_spmv if snake else jpaged.paged_semiring_spmv
    want = np.asarray(fn(jl, jnp.asarray(x), semiring, interpret=True))
    got = bucketed_semiring_spmv(tl, torch.from_numpy(x), semiring).numpy()
    return [(got, want, semiring != "plus_times", None)]


def _sparse_spmv(semiring):
    pad = _BIG if semiring == "min_plus" else 0.0
    jl, tl = _layouts(pad)
    rng = np.random.default_rng(2)
    act, om = _masks(rng)
    ident = np.inf if semiring == "min_plus" else 0.0
    x = np.where(act, rng.random(V) + 0.1, ident).astype(np.float32)
    out = []
    for mask in (None, om):
        want = np.asarray(jpaged.paged_semiring_spmv_sparse(
            jl, jnp.asarray(x), jnp.asarray(act), semiring, interpret=True,
            out_mask=None if mask is None else jnp.asarray(mask)))
        got = bucketed_semiring_spmv_sparse(
            tl, torch.from_numpy(x), torch.from_numpy(act), semiring,
            out_mask=None if mask is None else torch.from_numpy(mask)).numpy()
        out.append((got, want, semiring != "plus_times", mask))
    return out


def _spmm(sparse):
    rng = np.random.default_rng(3)
    act, om = _masks(rng)
    out = []
    for exact in (False, True):
        # exact mode: signed one-hot X over 0/1 values, so that every
        # message is a small integer (the JAX kernel keeps one bf16 operand)
        jl, tl = _layouts(binary=exact)
        x = (rng.integers(-1, 2, (V, 8)) if exact
             else rng.random((V, 8))).astype(np.float32)
        if not sparse:
            want = np.asarray(jpaged.paged_spmm(jl, jnp.asarray(x),
                                                interpret=True, exact=exact))
            got = bucketed_spmm(tl, torch.from_numpy(x), exact=exact).numpy()
            out.append((got, want, exact, None))
            continue
        x = np.where(act[:, None], x, 0.0).astype(np.float32)
        for mask in (None, om):
            want = np.asarray(jpaged.paged_spmm_sparse(
                jl, jnp.asarray(x), jnp.asarray(act), interpret=True,
                exact=exact,
                out_mask=None if mask is None else jnp.asarray(mask)))
            got = bucketed_spmm_sparse(
                tl, torch.from_numpy(x), torch.from_numpy(act), exact=exact,
                out_mask=None if mask is None else torch.from_numpy(mask),
            ).numpy()
            out.append((got, want, exact, mask))
    return out


def _minmax():
    jl, tl = _layouts()
    rng = np.random.default_rng(4)
    act, om = _masks(rng)
    x = np.where(act, rng.random(V) + 0.1, 0.0).astype(np.float32)
    out = []
    for mask in (None, om):
        want = jpaged.paged_semiring_spmv_sparse_minmax(
            jl, jnp.asarray(x), jnp.asarray(act), interpret=True,
            out_mask=None if mask is None else jnp.asarray(mask))
        got = bucketed_semiring_spmv_sparse_minmax(
            tl, torch.from_numpy(x), torch.from_numpy(act),
            out_mask=None if mask is None else torch.from_numpy(mask))
        out += [(g.numpy(), np.asarray(w), True, mask)
                for g, w in zip(got, want)]
    return out


CASES = {
    # JAX kernel (gunrock_tpu/ops/pallas/paged.py): the port's kernel
    "paged_semiring_spmv": lambda: sum(
        (_dense(sr, False) for sr in ("plus_times", "max_times", "min_plus")),
        []),
    "paged_semiring_spmv_sparse": lambda: sum(
        (_sparse_spmv(sr) for sr in ("plus_times", "max_times", "min_plus")),
        []),
    "paged_spmm": lambda: _spmm(False),
    "paged_spmm_sparse": lambda: _spmm(True),
    "paged_semiring_spmv_sparse_minmax": _minmax,
    "snake_semiring_spmv": lambda: sum(
        (_dense(sr, True) for sr in ("plus_times", "max_times", "min_plus")),
        []),
}


@pytest.mark.parametrize("kernel", list(CASES))
def test_port_kernel_matches_paged_twin(kernel):
    comparisons = CASES[kernel]()
    assert comparisons
    for got, want, exact, mask in comparisons:
        sel = np.ones(V, bool) if mask is None else mask
        got, want = got[sel], want[sel]
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        assert fin.any() and (want[fin] != 0).any()
        if exact:
            np.testing.assert_array_equal(got[fin], want[fin])
        else:
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                       atol=1e-5)
