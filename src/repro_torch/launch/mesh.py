"""The device mesh: axis names and sizes, and a mesh over the ranks of
the process group.

The counterpart of ``repro.launch.mesh``. The reference lowers every
(arch x shape) cell on a production mesh of 256 devices (single pod) or
512 (two pods) in one process, and its train driver runs its step on one
of them. A `Mesh` here is the axes and sizes, which is all the dry run
(`dryrun`) and the sharding rules need; a `RankMesh` is a `Mesh` over
the ranks of a ``torch.distributed`` process group, one rank a device
(PyTorch's idiom, where the reference runs one process over all its
devices), with this rank's coordinates and a process group for each axis
and for the data axes together.

Mesh shapes:
* single-pod:  (data=16, model=16)            — 256 devices
* multi-pod:   (pod=2, data=16, model=16)     — 512 devices, 2 pods
* debug:       (data=1, model=n)              — every rank there is
The ``pod`` axis carries only data parallelism; ``data`` is FSDP within a
pod; ``model`` is tensor/expert parallelism. Ranks lie on a mesh in
row-major order, as ``jax.make_mesh`` lays out devices.
"""
from __future__ import annotations

import datetime
import math
import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.device import rank_device
from repro_torch.parallel.collectives import Stats
from repro_torch.parallel.placement import axes_of

#: the driver's ``--mesh`` choices, as the reference's
MESHES = ("debug", "prod", "multipod")


@dataclass(frozen=True)
class Mesh:
    """Axis name -> size, in ``axis_names`` order."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """``16x16``, ``2x16x16``, ``1x1``."""
        return "x".join(map(str, self.sizes))


@dataclass(frozen=True, eq=False)
class RankMesh(Mesh):
    """A `Mesh` whose devices are the ranks of the process group.

    ``groups`` maps a tuple of axes to this rank's process group over
    them (the ranks that share its coordinates on every other axis, in
    the order of their combined coordinate); axes of size 1 have none,
    and a collective over them is no collective at all. ``device`` is
    this rank's device, ``backend`` the process group's, and ``stats``
    counts the collectives run over the mesh.
    """

    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: str | None = None
    groups: dict = field(default_factory=dict, repr=False)
    stats: Stats = field(default_factory=Stats, repr=False)

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes_of(axes))

    def index(self, axes) -> int:
        """This rank's combined coordinate over ``axes``, the first the
        most significant (a PartitionSpec's order for a tuple entry)."""
        i, coords = 0, self.coords
        for a in axes_of(axes):
            i = i * self.shape[a] + coords[a]
        return i

    def group(self, axes):
        """The process group over ``axes``, or None where they hold one
        rank."""
        axes = tuple(a for a in self.axis_names if a in axes_of(axes))
        if self.axes_size(axes) == 1:
            return None
        if axes == self.axis_names:
            return dist.group.WORLD
        return self.groups[axes]


def _group_axes(axis_names, sizes) -> list[tuple[str, ...]]:
    """The axis tuples a step reduces over: each axis, and the data axes
    together where there are two; those of one rank need no group."""
    shape = dict(zip(axis_names, sizes))
    out = [(a,) for a in axis_names]
    both = data_axes(Mesh(axis_names, sizes))
    if len(both) > 1:
        out.append(both)
    return [axes for axes in out if math.prod(shape[a] for a in axes) > 1
            and axes != tuple(axis_names)]


def rank_mesh(axis_names, sizes, *, device=None, backend=None) -> RankMesh:
    """A `RankMesh` of the given axes over the process group (a world of
    one when there is none). Every rank must call it, in the same order
    as every other mesh it builds: it creates the mesh's process
    groups."""
    axis_names, sizes = tuple(axis_names), tuple(sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = math.prod(sizes)
    if n != world:
        raise SystemExit(f"a {'x'.join(map(str, sizes))} mesh needs {n} "
                         f"ranks; the process group has {world}")
    groups = {}
    for axes in _group_axes(axis_names, sizes):
        keep = [i for i, a in enumerate(axis_names) if a not in axes]
        members: dict = {}
        for r in range(world):
            c = _unravel(r, sizes)
            members.setdefault(tuple(c[i] for i in keep), []).append(r)
        for ranks in members.values():     # every rank creates every group
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = g
    return RankMesh(axis_names, sizes, rank=rank,
                    device=torch.device(device or "cpu"), backend=backend,
                    groups=groups)


def _unravel(r: int, sizes) -> list[int]:
    out = []
    for n in reversed(sizes):
        out.append(r % n)
        r //= n
    return out[::-1]


def make_rank_mesh(kind: str = "debug", *, device=None,
                   backend=None) -> RankMesh:
    """The driver's ``--mesh``: ``debug`` spreads (1, n) over every rank,
    ``prod`` is 16x16 and ``multipod`` 2x16x16, which need 256 and 512
    ranks and exit with the reason on any other world, as
    ``jax.make_mesh`` fails."""
    if kind not in MESHES:
        raise SystemExit(f"--mesh {kind!r} is not one of {MESHES}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if kind == "debug":
        mesh = make_debug_mesh(world)
    else:
        mesh = make_production_mesh(multi_pod=kind == "multipod")
    if mesh.size != world:
        raise SystemExit(f"--mesh {kind} is {mesh.name}: it needs "
                         f"{mesh.size} ranks, and the process group has "
                         f"{world}")
    return rank_mesh(mesh.axis_names, mesh.sizes, device=device,
                     backend=backend)


def join_mesh(kind: str = "debug", *, device=None, backend=None,
              timeout_s: float = 600.0) -> RankMesh:
    """This process's rank of the ``--mesh`` ``kind``. Joins the process
    group that ``torch.distributed.run`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) unless one is
    initialized already; without either it is a world of one. NCCL on
    ``cuda:{LOCAL_RANK}`` by default (`rank_device`: one card a rank),
    gloo on the CPU; a caller that passes both ``device`` and
    ``backend="gloo"`` puts its ranks where ``device`` says, one card
    for all of them if it names one."""
    dev = rank_device(device, shared=backend == "gloo" and device is not None)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        backend = backend or dist.get_backend()
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(
                backend, init_method="env://",
                timeout=datetime.timedelta(seconds=timeout_s))
    return make_rank_mesh(kind, device=dev, backend=backend)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_debug_mesh(devices: int = 1) -> Mesh:
    """A (1, n) mesh: one device by default."""
    return Mesh(("data", "model"), (1, devices))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry the batch dimension (pod included if present)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]
