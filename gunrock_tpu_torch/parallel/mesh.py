"""The process mesh: one process (rank) per vertex shard, on
``torch.distributed``.

The port's counterpart of ``gunrock_tpu/parallel/mesh.py``. JAX runs one
SPMD program over a device mesh in one process (``shard_map``); the port
runs one process per shard. :func:`spawn` starts the ranks (the one-process
entry that JAX's ``shard_map`` gives its callers), :func:`make_mesh` and
:func:`make_mesh_2d` describe them from inside a rank, and
``collectives.py`` holds the counterparts of the ``jax.lax`` collectives.

Device and backend rule:

- rank r runs on ``cuda:(r % torch.cuda.device_count())`` (``device=
  "cuda"``, the default), or on the CPU when the caller asks for it
  (``device="cpu"``, as the tests do);
- the backend is NCCL when every rank has a card of its own, and gloo
  otherwise: when ranks share a card, and on the CPU;
- under gloo with ranks on cards, the collectives copy each operand to the
  host for the collective and the result back (``Mesh.staged``). This is
  one explicit code path, not a fallback: the kernels still run on the
  card;
- a failed NCCL init raises; nothing retries on gloo;
- ``device="cuda"`` without a card raises, as everywhere in the port.

:func:`spawn` rendezvouses through a ``file://`` store in a temporary
directory: no network and no ``torchrun``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from gunrock_tpu_torch.device import DEFAULT, resolve

EDGE_AXIS = "edges"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. Shard ids run host-major over
    ``shape``; ``groups[name]`` is the process group of this rank's peers
    along axis ``name`` (None: every rank)."""

    rank: int
    size: int
    axis_names: tuple
    shape: tuple
    device: torch.device
    backend: str
    groups: dict

    @property
    def staged(self) -> bool:
        """Whether collectives go through the host (gloo, ranks on cards)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def coords(self) -> tuple:
        """This rank's index along each axis."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))


def backend_for(device, n: int) -> str:
    """NCCL when each of ``n`` ranks has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:(rank % cards)`` or the
    CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _world(n_devices: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a rank: start the ranks "
                           "with spawn() or init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested {n_devices} shards, the process group "
                         f"has {world} ranks")
    return world


def make_mesh(n_devices: int | None = None, axis_name: str = EDGE_AXIS,
              device=DEFAULT) -> Mesh:
    """1-D mesh over every rank of the process group (``n_devices``, when
    given, must be its size), this rank on ``device``'s rule."""
    world = _world(n_devices)
    rank = dist.get_rank()
    return Mesh(rank=rank, size=world, axis_names=(axis_name,),
                shape=(world,), device=rank_device(device, rank),
                backend=dist.get_backend(), groups={axis_name: None})


def make_mesh_2d(n_hosts: int, chips_per_host: int | None = None,
                 axis_names: tuple[str, str] = ("host", "chip"),
                 device=DEFAULT) -> Mesh:
    """Hierarchical (host, chip) mesh over every rank, shard ids
    host-major: rank r is chip ``r % chips_per_host`` of host ``r //
    chips_per_host``. The outer axis's groups join the ranks of one chip
    index across hosts, the inner axis's the ranks of one host; every rank
    creates every group, in the same order, as ``new_group`` requires."""
    world = _world(None)
    if chips_per_host is None:
        chips_per_host = world // n_hosts
    if n_hosts * chips_per_host != world:
        raise ValueError(f"a {n_hosts}x{chips_per_host} mesh needs "
                         f"{n_hosts * chips_per_host} ranks, the process "
                         f"group has {world}")
    rank = dist.get_rank()
    host, chip = divmod(rank, chips_per_host)
    groups = {}
    for c in range(chips_per_host):
        g = dist.new_group([h * chips_per_host + c for h in range(n_hosts)])
        if c == chip:
            groups[axis_names[0]] = g
    for h in range(n_hosts):
        g = dist.new_group([h * chips_per_host + c
                            for c in range(chips_per_host)])
        if h == host:
            groups[axis_names[1]] = g
    return Mesh(rank=rank, size=world, axis_names=tuple(axis_names),
                shape=(n_hosts, chips_per_host),
                device=rank_device(device, rank), backend=dist.get_backend(),
                groups=groups)


@dataclasses.dataclass(frozen=True)
class _GraphFile:
    """A port Graph sent to the ranks as its host arrays in a file of the
    spawn's temporary directory (not through shared memory, whose size a
    container may cap)."""

    path: str
    n_vertices: int
    properties: object


def _pack(arg, tmp: Path, count):
    """``arg`` with every port Graph in it (through lists, tuples and
    dicts) replaced by a :class:`_GraphFile` in ``tmp``."""
    from gunrock_tpu_torch.graph import Graph

    if isinstance(arg, Graph):
        path = tmp / f"graph{next(count)}.npz"
        np.savez(path, **arg.host)
        return _GraphFile(str(path), arg.n_vertices, arg.properties)
    if isinstance(arg, dict):
        return {k: _pack(v, tmp, count) for k, v in arg.items()}
    if type(arg) in (list, tuple):
        return type(arg)(_pack(v, tmp, count) for v in arg)
    return arg


def _unpack(arg, device):
    """The inverse of :func:`_pack`, each Graph built on ``device``."""
    from gunrock_tpu_torch.graph import Graph

    if isinstance(arg, _GraphFile):
        with np.load(arg.path) as f:
            arrays = {k: f[k] for k in f.files}
        return Graph.from_arrays(arrays, arg.n_vertices, arg.properties,
                                 device=device)
    if isinstance(arg, dict):
        return {k: _unpack(v, device) for k, v in arg.items()}
    if type(arg) in (list, tuple):
        return type(arg)(_unpack(v, device) for v in arg)
    return arg


def _to_cpu(obj):
    """``obj`` with every tensor in it (through lists, tuples and dicts) on
    the CPU, for the trip back to the caller."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if type(obj) in (list, tuple):
        return type(obj)(_to_cpu(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _worker(rank: int, fn, n: int, device: str, backend: str,
            init_method: str, out: str, args: tuple) -> None:
    # every rank of a spawn is on this host: the loopback carries it all
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=n,
        device_id=dev if backend == "nccl" else None)
    try:
        result = fn(*_unpack(args, dev))
        if rank == 0:
            torch.save(_to_cpu(result), out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, *args, device=DEFAULT):
    """Run ``fn(*args)`` in ``n`` ranks, one process each, and return rank
    0's result (its tensors on the CPU). ``fn`` must be importable by
    name (a module-level function); it builds its mesh with
    :func:`make_mesh` or :func:`make_mesh_2d` on the same ``device``. A
    port ``Graph`` among ``args`` reaches each rank on that rank's device.
    A rank that raises stops the others, and ``spawn`` raises with its
    traceback.

    On a card, every kernel library is built here, once, before the ranks
    start, so that they load it and never race ``nvcc`` into the build
    directory."""
    dev = resolve(device)
    if dev.type == "cuda":
        from gunrock_tpu_torch.ops.kernels import _build

        _build.build()
    backend = backend_for(dev, n)
    with tempfile.TemporaryDirectory(prefix="gunrock_mesh_") as tmp:
        tmp = Path(tmp)
        out = tmp / "result.pt"
        packed = _pack(args, tmp, itertools.count())
        torch.multiprocessing.spawn(
            _worker, nprocs=n, join=True,
            args=(fn, n, dev.type, backend, f"file://{tmp / 'store'}",
                  str(out), packed))
        return torch.load(out, weights_only=False)
