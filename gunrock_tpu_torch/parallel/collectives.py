"""Collectives over a :class:`~gunrock_tpu_torch.parallel.mesh.Mesh`: the
port's counterparts of the ``jax.lax`` collectives that
``gunrock_tpu/parallel/sharded.py`` uses, on ``torch.distributed``.

Each takes ``axis``: None (or the tuple of every axis name) for the whole
mesh, or one axis name for this rank's group along that axis.
``all_to_all`` over a (host, chip) mesh runs in two stages as JAX's
``_a2a_shards`` does: the outer axis first, then the inner, with the same
result as the flat exchange.

Under gloo with ranks on cards (``mesh.staged``) every operand is copied to
the host for the collective and the result back to the card; bool tensors
travel as uint8. Scalars (Python numbers) reduce to Python numbers.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gunrock_tpu_torch.parallel.mesh import Mesh


def _whole(mesh: Mesh, axis) -> bool:
    if axis is None:
        return True
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return set(names) == set(mesh.axis_names)


def _group(mesh: Mesh, axis):
    """The process group of ``axis`` (None: every rank)."""
    if _whole(mesh, axis):
        return None
    if not isinstance(axis, str):
        raise NotImplementedError(f"collectives over the axes {axis} of a "
                                  f"{mesh.axis_names} mesh")
    return mesh.groups[axis]


def axis_size(mesh: Mesh, axis=None) -> int:
    if _whole(mesh, axis):
        return mesh.size
    return mesh.shape[mesh.axis_names.index(axis)]


def axis_index(mesh: Mesh, axis=None) -> int:
    """This rank's shard id (host-major over the whole mesh) or its index
    along one axis."""
    if _whole(mesh, axis):
        return mesh.rank
    return mesh.coords[mesh.axis_names.index(axis)]


def _to_wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    t = x.to(torch.uint8) if x.dtype == torch.bool else x
    if mesh.staged:
        t = t.cpu()
    return t.contiguous()


def _from_wire(t: torch.Tensor, like: torch.Tensor, mesh: Mesh):
    if mesh.staged:
        t = t.to(mesh.device)
    return t.to(torch.bool) if like.dtype == torch.bool else t


def _all_reduce(x, mesh: Mesh, axis, op):
    if isinstance(x, torch.Tensor):
        t = _to_wire(x, mesh)
        if t is x:
            t = t.clone()
        dist.all_reduce(t, op=op, group=_group(mesh, axis))
        return _from_wire(t, x, mesh)
    wire = "cpu" if mesh.backend == "gloo" else mesh.device
    dtype = torch.float64 if isinstance(x, float) else torch.int64
    t = torch.tensor(x, dtype=dtype, device=wire)
    dist.all_reduce(t, op=op, group=_group(mesh, axis))
    return t.item()


def psum(x, mesh: Mesh, axis=None):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x, mesh: Mesh, axis=None):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmin(x, mesh: Mesh, axis=None):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def all_gather(x: torch.Tensor, mesh: Mesh, axis=None,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in shard order: concatenated along axis 0
    (``tiled``), else stacked on a new axis 0."""
    t = _to_wire(x, mesh)
    out = torch.empty((axis_size(mesh, axis),) + tuple(t.shape),
                      dtype=t.dtype, device=t.device)
    dist.all_gather(list(out.unbind(0)), t, group=_group(mesh, axis))
    if tiled:
        out = out.reshape((-1,) + tuple(t.shape[1:]))
    return _from_wire(out, x, mesh)


def _a2a(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    t = _to_wire(x, mesh)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=_group(mesh, axis))
    return _from_wire(out, x, mesh)


def all_to_all(send: torch.Tensor, mesh: Mesh, axis=None) -> torch.Tensor:
    """Exchange per-destination blocks: ``send[d]`` goes to shard d, and
    row e of the result is what shard e sent here. Over a (host, chip)
    mesh: the outer axis exchanges per-host blocks first, then the inner
    axis reroutes within each host."""
    if axis is None:
        axis = mesh.axis_names if len(mesh.axis_names) > 1 else \
            mesh.axis_names[0]
    if isinstance(axis, str):
        return _a2a(send, mesh, axis)
    if len(axis) == 1:
        return _a2a(send, mesh, axis[0])
    if len(axis) != 2:
        raise NotImplementedError("meshes deeper than (host, chip)")
    outer, inner = axis
    nh, nc = axis_size(mesh, outer), axis_size(mesh, inner)
    s4 = send.reshape((nh, nc) + tuple(send.shape[1:]))
    a = _a2a(s4, mesh, outer).transpose(0, 1).contiguous()
    b = _a2a(a, mesh, inner)
    return b.transpose(0, 1).reshape(send.shape)


def ppermute(x: torch.Tensor, mesh: Mesh, perm) -> torch.Tensor:
    """Send ``x`` along ``perm`` (pairs (source shard, destination shard)
    over the whole mesh) with ``isend``/``irecv``; a shard that receives
    nothing gets zeros."""
    me = mesh.rank
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    t = _to_wire(x, mesh)
    out = torch.zeros_like(t)
    if dst == [me] and src == [me]:
        out.copy_(t)
        return _from_wire(out, x, mesh)
    ops = [dist.P2POp(dist.isend, t, d) for d in dst]
    ops += [dist.P2POp(dist.irecv, out, s) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(out, x, mesh)
