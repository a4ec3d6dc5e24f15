"""batch: run a per-source job over many sources at once (port of
``gunrock_tpu/ops/batch.py``; role of reference
``operators/batch/batch.hxx:61-84``, a ``std::thread`` fan-out sharing
one GPU, used by BC from every source and multi-seed PPR).

``torch.func.vmap`` over the source axis, in chunks of ``chunk_size``
sources that run one after another to bound peak memory. Under ``vmap``
``fn`` must be traceable the way ``jax.vmap`` requires: no ``.item()``,
``int()``/``bool()`` of a tensor or Python branch on its value, and no
in-place write into a tensor it captured (it returns new tensors). A
function that breaks this raises; ``batch`` does not fall back to a loop.
"""

from __future__ import annotations

from typing import Callable

import torch


def _map(f, tree):
    """``f`` over the tensors of a tuple/list/dict tree of tensors."""
    if isinstance(tree, torch.Tensor):
        return f(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(f, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    raise TypeError(f"batch: fn returned a {type(tree).__name__}, not a "
                    "tensor or a tuple/list/dict of tensors")


def _cat(outs: list):
    """Concatenate same-shaped trees along their leading axis."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(outs)
    if isinstance(first, (tuple, list)):
        return type(first)(_cat([o[i] for o in outs]) for i in range(len(first)))
    return {k: _cat([o[k] for o in outs]) for k in first}


def batch(fn: Callable, sources, chunk_size: int | None = None):
    """Apply ``fn(source) -> tensor tree`` over a 1-D tensor of sources.

    Returns the tree with a leading source axis. Sources within a chunk
    are vectorized; chunks run one after another. The last chunk is
    padded with the last source and the padding trimmed, so every chunk
    has one shape."""
    sources = torch.as_tensor(sources)
    n = sources.shape[0]
    vfn = torch.func.vmap(fn)
    if chunk_size is None or chunk_size >= n:
        return vfn(sources)
    n_chunks = -(-n // chunk_size)
    padded = torch.cat([sources,
                        sources[-1:].expand(n_chunks * chunk_size - n)])
    outs = [vfn(c) for c in padded.reshape(n_chunks, chunk_size)]
    return _map(lambda t: t[:n], _cat(outs))
