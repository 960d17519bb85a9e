"""GSPMD sharding rules for params, optimizer state, batches and caches,
as data.

The counterpart of ``repro.launch.sharding``, rule for rule. Scheme: 2-D
param sharding —
* the *feature/contracting-adjacent* large dim over ``model`` (TP/EP),
* the other large dim over the batch axes (``(pod,) data``) = FSDP/ZeRO-3,
* optimizer moments inherit the param specs (ZeRO-3),
* activations: batch over ``(pod, data)``, features over ``model``.

Every rule is divisibility-guarded: a mesh axis is only assigned to a
tensor dim it divides evenly (kv_heads=8 cannot shard over model=16 ->
replicated; yi-34b's 56 heads shard over the flattened H*head_dim dim
instead).

A spec is a plain tuple with one entry per dim: ``None`` (replicated),
an axis name, or a tuple of axis names. The reference's ``PartitionSpec``
of a replicated leaf is empty; here it is all ``None``. A "sharding" of a
tree is the tree of its leaves' specs, and `tree_bytes` sums the bytes
one device holds under them. Trees are the port's nested dicts (and
`TrainState`), whose leaf names are the reference's, so the '/'-joined
paths the rules match are the reference's paths.

On a `RankMesh` (``launch/mesh.py``) the same specs place real tensors:
`local_shard` cuts this rank's shard of a whole tensor, `gather_full`
makes it whole again, `state_to_mesh` / `state_from_mesh` do that for a
whole `TrainState`, and `Sharded` fetches the part of a weight that one
rank's share of a layer's work reads (`Sharded.weight`).
"""
from __future__ import annotations

import dataclasses
import math
import re
from dataclasses import fields, is_dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import axes_of, data_axes


def _fits(dim: int, mesh, axes) -> bool:
    """Mesh axes (str or tuple) divide `dim` evenly."""
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dim % size == 0


def _guard(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop any axis assignment that does not divide its dim. A spec
    shorter than the shape applies to the leading dims, as a
    PartitionSpec does; the rest are replicated."""
    out = []
    for dim, axes in zip(shape, spec):
        if not _fits(dim, mesh, axes):
            axes = None
        if isinstance(axes, tuple) and len(axes) == 1:
            # ('x',) -> 'x': the same partitioning, one spelling
            axes = axes[0]
        out.append(axes)
    return tuple(out) + (None,) * (len(shape) - len(out))


def replicated(shape) -> tuple:
    return (None,) * len(shape)


# --------------------------------------------------------------- param rules
#
# Path-pattern -> (spec template, using 'F' for the FSDP axes tuple and
# 'M' for the model axis; None = replicated). Templates are matched
# against '/'-joined tree paths; first match wins. Leading layer-stack
# axes are handled by padding the template with None on the left.

_PARAM_RULES: list[tuple[str, tuple | None]] = [
    # embeddings / heads: vocab over model (TP vocab), feature over FSDP
    (r"embed$",               ("M", "F")),
    (r"lm_head$",             ("F", "M")),
    # attention projections (D, H*hd) / (H*hd, D)
    (r"attn/w[qkv]$",         ("F", "M")),
    (r"attn/wo$",             ("M", "F")),
    (r"xattn/w[qkv]$",        ("F", "M")),
    (r"xattn/wo$",            ("M", "F")),
    (r"attn/b[qkv]$",         ("M",)),
    (r"attn/[qk]_norm$",      (None,)),
    # dense MLP (D, F) / (F, D)
    (r"mlp/w_(gate|up)$",     ("F", "M")),
    (r"mlp/w_down$",          ("M", "F")),
    # MoE: experts over model (EP), expert-internal dims FSDP
    (r"moe/router$",          ("F", None)),
    (r"moe/w_(gate|up)$",     ("M", "F", None)),
    (r"moe/w_down$",          ("M", None, "F")),
    # Mamba: d_inner over model, D over FSDP
    (r"mamba/in_proj$",       ("F", "M")),
    (r"mamba/out_proj$",      ("M", "F")),
    (r"mamba/x_proj$",        ("M", None)),
    (r"mamba/dt_proj$",       (None, "M")),
    (r"mamba/(conv_w)$",      (None, "M")),
    (r"mamba/(conv_b|dt_bias|D_skip)$", ("M",)),
    (r"mamba/A_log$",         ("M", None)),
    # norms and anything 1-D: replicated
    (r".*",                   None),
]


def _path_str(path) -> str:
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


def param_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    fsdp = data_axes(mesh)
    # MoE expert weights: EP over `model` when E divides it; otherwise
    # TP *within* each (replicated) expert — shard the FFN width
    m = re.search(r"moe/w_(gate|up|down)$", path)
    if m and len(shape) >= 3 and shape[-3] % mesh.shape["model"] != 0:
        if m.group(1) == "down":                  # (E, F, D)
            return _guard((None, "model", fsdp), shape, mesh)
        return _guard((None, fsdp, "model"), shape, mesh)  # (E, D, F)
    for pat, template in _PARAM_RULES:
        if re.search(pat, path):
            if template is None:
                return replicated(shape)
            tpl = [fsdp if t == "F" else ("model" if t == "M" else None)
                   for t in template]
            # stacked-layer (or stacked-expert) leading axes -> None
            pad = len(shape) - len(tpl)
            tpl = [None] * pad + tpl
            return _guard(tuple(tpl), shape, mesh)
    return replicated(shape)


def _map_specs(rule, tree):
    """``rule(path_str, shape)`` at every leaf, as a flat {path: spec}."""
    return {_path_str(p): rule(_path_str(p), tuple(leaf.shape))
            for p, leaf in leaves_with_paths(tree)}


def param_shardings(param_structs: Any, mesh) -> dict:
    """{path: spec} of a params tree."""
    return _map_specs(lambda p, s: param_spec(p, s, mesh), param_structs)


def state_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """TrainState: step replicated; params/mu/nu/err share param specs."""
    if path.startswith(("params/", "mu/", "nu/", "err/")):
        return param_spec(path.split("/", 1)[1], shape, mesh)
    return replicated(shape)


def state_shardings(state: Any, mesh) -> dict:
    return _map_specs(lambda p, s: state_spec(p, s, mesh), state)


# --------------------------------------------------------------- batch rules

def batch_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    """Token/embedding batches: batch dim over (pod, data)."""
    fsdp = data_axes(mesh)
    spec: list = [fsdp if _fits(shape[0], mesh, fsdp) else None]
    spec += [None] * (len(shape) - 1)
    return tuple(spec)


def batch_shardings(batch: Any, mesh) -> dict:
    return _map_specs(lambda p, s: batch_spec(p, s, mesh), batch)


# --------------------------------------------------------------- cache rules

def cache_spec(path: str, shape: tuple[int, ...], mesh,
               kind: str = "decode") -> tuple:
    """Decode caches (leading layer axis, then batch):

    * attention k/v (L, B, W, K, hd): batch over FSDP axes; HEAD_DIM over
      `model`, so a decode step's ring write stays partition-local;
    * cross k/v likewise; ssm conv/ssm states: d_inner over `model`;
    * slot_pos (B, W): replicated W, batch over FSDP.

    A prefill (``kind="prefill"``) writes the whole window sequentially
    and shards k/v's W over `model` instead.
    """
    fsdp = data_axes(mesh)
    leaf = path.split("/")[-1]
    if leaf in ("k", "v", "cross_k", "cross_v"):
        if kind == "prefill":
            return _guard((None, fsdp, "model", None, None), shape, mesh)
        return _guard((None, fsdp, None, None, "model"), shape, mesh)
    if leaf == "conv":
        return _guard((None, fsdp, None, "model"), shape, mesh)
    if leaf == "ssm":
        return _guard((None, fsdp, "model", None), shape, mesh)
    if leaf == "slot_pos":
        return _guard((fsdp, None), shape, mesh)
    if leaf == "pos":
        return _guard((fsdp,), shape, mesh)
    # scalars / counters
    return replicated(shape)


def cache_shardings(cache: Any, mesh, kind: str = "decode") -> dict:
    return _map_specs(lambda p, s: cache_spec(p, s, mesh, kind), cache)


# ----------------------------------------------------------------- logits

def logits_spec(mesh, shape: tuple[int, ...] | None = None) -> tuple:
    """(B, S, V) logits: batch over FSDP axes, vocab over model —
    divisibility-guarded (long_500k has B=1; internvl2's vocab is odd)."""
    fsdp = data_axes(mesh)
    if shape is None:
        return (fsdp, None, "model")
    return _guard((fsdp, None, "model"), shape, mesh)


# ------------------------------------------------------------------ bytes

def leaf_bytes(shape: tuple[int, ...], itemsize: int, spec: tuple,
               mesh) -> int:
    """The bytes of one leaf on one device under ``spec``: its bytes over
    the product of the sizes of the axes it is split over. Exact, since
    every rule assigns an axis only where it divides the dim."""
    sizes = [math.prod(mesh.shape[a] for a in ((axes,) if isinstance(
        axes, str) else axes or ())) for axes in spec]
    if len(spec) != len(shape) or any(d % n for d, n in zip(shape, sizes)):
        raise ValueError(f"{spec} does not split {shape} evenly")
    return math.prod(shape) * itemsize // math.prod(sizes)


def tree_bytes(tree: Any, specs: dict, mesh) -> int:
    """The bytes one device holds of ``tree`` under ``specs`` ({path:
    spec}, as the ``*_shardings`` functions give)."""
    return sum(leaf_bytes(tuple(leaf.shape), leaf.element_size(),
                          specs[_path_str(p)], mesh)
               for p, leaf in leaves_with_paths(tree))


# ------------------------------------------------------- on a RankMesh

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
    return fn(_path_str(path), tree)


class Sharded:
    """A params tree placed on a `RankMesh` by the reference's rules, and
    the fetch of the weights one rank's share of a layer reads.

    ``structs`` is the whole params tree (meta tensors will do: only
    shapes are read). Work split over ``model`` takes this rank's
    contiguous share of a dim of n: ``split(n)``. `weight` returns the
    range of a weight that share reads: its FSDP dims gathered over the
    data axes (`collectives.gather`: the gradient is reduce-scattered
    back to the shard); along the model dim this rank's own shard where
    that is the range, else the leaf gathered over ``model`` and cut
    (counted in ``gathers``, by path: a shard that is not whole heads), or
    a replicated leaf cut (its gradient summed over ``model``)."""

    def __init__(self, mesh, structs):
        self.mesh = mesh
        self.specs = param_shardings(structs, mesh)
        self.shapes = {_path_str(p): tuple(leaf.shape)
                       for p, leaf in leaves_with_paths(structs)}
        self.data = data_axes(mesh)
        self.gathers: dict[str, int] = {}

    # ----------------------------------------------------------- layout
    def split(self, n: int) -> tuple[int, int]:
        """This rank's share [lo, hi) of n over ``model``."""
        M, m = self.mesh.shape["model"], self.mesh.coords["model"]
        return m * n // M, (m + 1) * n // M

    def spec(self, path: str, ndim: int | None = None) -> tuple:
        """The spec of ``path``; with ``ndim`` that of one layer's slice
        of a stacked leaf (the leading entries dropped)."""
        spec = self.specs[path]
        return spec[len(spec) - (ndim or len(spec)):]

    def shape(self, path: str, ndim: int | None = None) -> tuple:
        shape = self.shapes[path]
        return shape[len(shape) - (ndim or len(shape)):]

    def state_specs(self, state) -> dict:
        """{path: spec} of a `TrainState` of these params (`state_spec`)."""
        return {_path_str(p): (state_spec(_path_str(p), self.shapes[
            _path_str(p).split("/", 1)[1]], self.mesh)
            if len(p) > 1 else replicated(leaf.shape))
            for p, leaf in leaves_with_paths(state)}

    # ------------------------------------------------------------ fetch
    def weight(self, leaf, path: str, dim: int, lo: int, hi: int):
        """[lo, hi) along ``dim`` of the weight at ``path`` (one layer's
        slice where the leaf is stacked), whole along its other dims."""
        spec, full = self.spec(path, leaf.dim()), self.shape(path, leaf.dim())
        for d, axes in enumerate(spec):
            if axes is not None and "model" not in axes_of(axes):
                leaf = C.gather(leaf, self.mesh, axes, d)       # FSDP
        if spec[dim] == "model":
            part = full[dim] // self.mesh.shape["model"]
            own = self.mesh.coords["model"] * part
            if (lo, hi) == (own, own + part):
                return leaf
            leaf = C.gather(leaf, self.mesh, "model", dim)
            self.gathers[path] = self.gathers.get(path, 0) + 1
        elif (lo, hi) != (0, full[dim]):
            leaf = C.copy_to(leaf, self.mesh, "model")
        return leaf.narrow(dim, lo, hi - lo)

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
