"""Tensors placed on a mesh of ranks by specs that the caller computes.

A spec is a plain tuple with one entry per dim: ``None`` (replicated),
an axis name, or a tuple of axis names; a spec shorter than its shape
does not occur here (the rules that make specs pad them). Trees are the
port's nested dicts and dataclasses (`TrainState`), and a leaf's path is
its keys joined with '/', the reference's path.

The mesh is any object with ``shape``, ``coords``, ``index``,
``axes_size``, ``group``, ``rank``, ``size``, ``backend``, ``device`` and
``stats`` (``repro_torch.launch.mesh.RankMesh``). Nothing here knows the
reference's rules: `Sharded` takes each params leaf's spec and the data
axes from whoever builds it (``repro_torch.launch.sharding.placement``).

`local_shard` cuts this rank's shard of a whole tensor, `gather_full`
makes it whole again, `state_to_mesh` / `state_from_mesh` do that for a
whole `TrainState` and `cache_to_mesh` / `cache_from_mesh` for a decode
cache, and `Sharded` fetches the part of a weight that one rank's share
of a layer's work reads (`Sharded.weight`, `Sharded.weight_ranges`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import fields, is_dataclass

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives as C


def axes_of(axes) -> tuple[str, ...]:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def path_str(path) -> str:
    """A leaf's path (the keys from the root) joined with '/'."""
    return "/".join(str(k) for k in path)


def leaves_with_paths(tree, path=()):
    """(path, leaf) over a tree of nested dicts, lists, tuples and
    dataclasses (`TrainState`), in insertion / field order; ``None`` is an
    empty subtree, as in the reference's trees."""
    if tree is None:
        return []
    if is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(path, tree)]
    return [pl for k, sub in items for pl in leaves_with_paths(sub, path
                                                               + (k,))]


def map_leaves(tree, fn, path=()):
    """``fn(path_str, leaf)`` at every leaf of a tree of dicts and
    dataclasses (`TrainState`), keeping its structure; None stays."""
    if tree is None:
        return None
    if is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(getattr(tree, f.name), fn, path + (f.name,))
            for f in fields(tree)})
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path_str(path), tree)


def _size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes_of(axes))


def shard_shape(shape: tuple[int, ...], spec: tuple, mesh) -> tuple:
    """The shape of one device's shard of a leaf of ``shape``."""
    return tuple(d // _size(mesh, axes) for d, axes in zip(shape, spec))


def local_shard(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec``: along each split dim
    the part at its combined coordinate over that dim's axes. A copy, so
    the whole tensor can be freed."""
    out = full
    for d, axes in enumerate(spec):
        if axes is not None:
            part = full.shape[d] // _size(mesh, axes)
            out = out.narrow(d, mesh.index(axes) * part, part)
    return out.clone(memory_format=torch.contiguous_format)


def gather_full(shard: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's ``shard`` (a collective: every
    rank calls it and every rank gets the whole)."""
    for d, axes in enumerate(spec):
        if axes is not None:
            shard = C.all_gather(shard, mesh, axes, d)
    return shard


class Sharded:
    """A params tree placed on a mesh, and the fetch of the weights one
    rank's share of a layer reads.

    ``specs`` is {path: spec} of every params leaf, ``shapes`` {path:
    shape} of the whole leaves, ``data`` the mesh's data axes (the batch
    is split over them; FSDP dims name them), ``state_rule(path)`` the
    spec of the `TrainState` leaf at ``path``. Work split over ``model``
    takes this rank's contiguous share of a dim of n: ``split(n)``.
    `weight` returns the range of a weight that share reads: its FSDP
    dims gathered over the data axes (`collectives.gather`: the gradient
    is reduce-scattered back to the shard); along the model dim this
    rank's own shard where that is the range, else the leaf gathered over
    ``model`` and cut (counted in ``gathers``, by path, once a fetch: a
    shard that is not whole heads, or not the rank's channels, or experts
    whose leaf splits another dim over ``model``), or a replicated leaf
    cut (its gradient summed over ``model``). `gather_data` stacks every
    data rank's tensor (the moe family's per-expert counts), and
    `rows_split` says whether the data axes split the batch."""

    def __init__(self, mesh, specs: dict, shapes: dict, data: tuple,
                 state_rule):
        self.mesh = mesh
        self.specs = dict(specs)
        self.shapes = {p: tuple(s) for p, s in shapes.items()}
        self.data = tuple(data)
        self.state_rule = state_rule
        self.gathers: dict[str, int] = {}

    # ----------------------------------------------------------- layout
    def split(self, n: int) -> tuple[int, int]:
        """This rank's share [lo, hi) of n over ``model``."""
        return self.splits(n)[self.mesh.coords["model"]]

    def splits(self, n: int) -> list[tuple[int, int]]:
        """Every ``model`` rank's share [lo, hi) of n, in coordinate
        order."""
        M = self.mesh.shape["model"]
        return [(m * n // M, (m + 1) * n // M) for m in range(M)]

    def spec(self, path: str, ndim: int | None = None) -> tuple:
        """The spec of ``path``; with ``ndim`` that of one layer's slice
        of a stacked leaf (the leading entries dropped)."""
        spec = self.specs[path]
        return spec[len(spec) - (ndim or len(spec)):]

    def shape(self, path: str, ndim: int | None = None) -> tuple:
        shape = self.shapes[path]
        return shape[len(shape) - (ndim or len(shape)):]

    def state_specs(self, state) -> dict:
        """{path: spec} of a `TrainState` of these params (whole or this
        rank's shards), by ``state_rule``."""
        return {path_str(p): self.state_rule(path_str(p))
                for p, _ in leaves_with_paths(state)}

    # ------------------------------------------------------------ fetch
    def weight(self, leaf, path: str, dim: int, lo: int, hi: int):
        """[lo, hi) along ``dim`` of the weight at ``path`` (one layer's
        slice where the leaf is stacked), whole along its other dims."""
        return self.weight_ranges(leaf, path, dim, ((lo, hi),))[0]

    def weight_ranges(self, leaf, path: str, dim: int, ranges):
        """The ``ranges`` ([lo, hi) each) along ``dim`` of the weight at
        ``path``, from one fetch: a list of tensors. A dim other than
        ``dim`` split over ``model`` (the MoE experts' fallback layout,
        cut along the expert dim) is gathered over ``model`` and counted:
        the ranks' ranges are then split work, and the gather's backward
        sums their gradients."""
        spec, full = self.spec(path, leaf.dim()), self.shape(path, leaf.dim())
        ranges = tuple(ranges)
        for d, axes in enumerate(spec):
            if axes is not None and "model" not in axes_of(axes):
                leaf = C.gather(leaf, self.mesh, axes, d)       # FSDP
        across = [d for d, axes in enumerate(spec)
                  if d != dim and axes == "model"]
        for d in across:
            leaf = C.gather(leaf, self.mesh, "model", d)
        if across:
            self.gathers[path] = self.gathers.get(path, 0) + 1
        elif spec[dim] == "model":
            part = full[dim] // self.mesh.shape["model"]
            own = self.mesh.coords["model"] * part
            if ranges == ((own, own + part),):
                return [leaf]
            leaf = C.gather(leaf, self.mesh, "model", dim)
            self.gathers[path] = self.gathers.get(path, 0) + 1
        elif ranges != ((0, full[dim]),):
            leaf = C.copy_to(leaf, self.mesh, "model")
        return [leaf.narrow(dim, lo, hi - lo) for lo, hi in ranges]

    def copy(self, x):
        """Megatron's f over ``model``: ``x`` enters work split over it."""
        return C.copy_to(x, self.mesh, "model")

    def reduce(self, x):
        """Megatron's g over ``model``: the sum of the split work."""
        return C.reduce_from(x, self.mesh, "model")

    def max(self, x):
        """The max of ``x`` over ``model`` (no gradient)."""
        return C.all_reduce(x.detach(), self.mesh, "model", "max")

    def sum_data(self, x):
        """The sum of ``x`` over the data axes (no gradient)."""
        return C.all_reduce(x.detach(), self.mesh, self.data)

    def gather_data(self, x, kind: str = "all_gather"):
        """Every data rank's ``x`` stacked along a new leading dim, in the
        order of their combined coordinate, the order the batch is split
        in (no gradient), counted under ``kind``."""
        return C.all_gather(x.detach()[None], self.mesh, self.data, 0,
                            kind=kind)

    @property
    def rows_split(self) -> bool:
        """Whether this rank's rows are its part of a batch split over the
        data axes (training's batch, and a serving batch whose
        ``cache/decode/pos`` spec splits it), not the whole batch
        replicated over them (a serving batch the data axes do not
        divide: the spec's guard leaves it whole)."""
        spec = self.specs.get("cache/decode/pos")
        return spec is None or spec[0] is not None

    def _split_over(self, path: str) -> set:
        return {a for entry in self.specs[path] for a in axes_of(entry)}

    def reduce_grad(self, path: str, g):
        """A leaf's gradient summed over the data axes its spec does not
        split it over (each data rank's is its batch's share)."""
        missing = tuple(a for a in self.data
                        if a not in self._split_over(path))
        return C.all_reduce(g, self.mesh, missing) if missing else g

    def holds_first_copy(self, path: str) -> bool:
        """Whether this rank is the first (coordinate 0) of the ranks that
        hold the same shard of ``path``: a global sum counts it there
        only."""
        split = self._split_over(path)
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a not in split)


def params_to_mesh(params, sharded: Sharded):
    """The shards of a whole params tree that this rank holds."""
    return map_leaves(params, lambda p, leaf: local_shard(
        leaf, sharded.specs[p], sharded.mesh))


def state_to_mesh(state, sharded: Sharded):
    """The shards of a whole `TrainState` that this rank holds."""
    specs = sharded.state_specs(state)
    return map_leaves(state, lambda p, leaf: local_shard(leaf, specs[p],
                                                          sharded.mesh))


def state_from_mesh(state, sharded: Sharded):
    """The whole `TrainState` from every rank's shards (a collective;
    every rank gets it)."""
    specs = sharded.state_specs(state)
    return map_leaves(state, lambda p, leaf: gather_full(leaf, specs[p],
                                                          sharded.mesh))


def cache_to_mesh(cache, sharded: Sharded, kind: str):
    """The shards of a whole decode cache that this rank holds in the
    ``kind`` ("prefill" or "decode") layout: each leaf by its spec at
    ``cache/{kind}/{name}`` (a serving placement's)."""
    return {name: local_shard(leaf, sharded.specs[f"cache/{kind}/{name}"],
                              sharded.mesh) for name, leaf in cache.items()}


def cache_from_mesh(cache, sharded: Sharded, kind: str):
    """The whole decode cache from every rank's shards in the ``kind``
    layout (a collective; every rank gets it)."""
    return {name: gather_full(leaf, sharded.specs[f"cache/{kind}/{name}"],
                              sharded.mesh) for name, leaf in cache.items()}


def state_bytes(state) -> int:
    """The bytes of the tensors of a (local) `TrainState`."""
    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in leaves_with_paths(state))


def broadcast_shard(full, shape, dtype, spec, mesh, src: int = 0):
    """This rank's shard of a tensor that only rank ``src`` holds whole
    (``full``; None elsewhere): broadcast, then cut (`local_shard`)."""
    staged = mesh.backend == "gloo" or mesh.device.type == "cpu"
    dev = torch.device("cpu") if staged else mesh.device
    buf = (full.to(dev) if mesh.rank == src
           else torch.empty(shape, dtype=dtype, device=dev))
    if dist.is_initialized() and mesh.size > 1:
        dist.broadcast(buf, src)
    return local_shard(buf, spec, mesh).to(mesh.device)
