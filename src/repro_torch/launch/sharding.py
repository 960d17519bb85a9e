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
`placement` builds the `repro_torch.parallel.placement.Sharded` of a
params tree from them (`serve_placement` of params plus a decode cache
and the logits), and the layers below ``launch`` (models, optim, data,
checkpoint) take it, or a spec, from their caller.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.launch.mesh import data_axes
from repro_torch.parallel.placement import (Sharded, leaves_with_paths,
                                            path_str)


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
    return {path_str(p): rule(path_str(p), tuple(leaf.shape))
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
                          specs[path_str(p)], mesh)
               for p, leaf in leaves_with_paths(tree))


# ------------------------------------------------------- on a RankMesh

def placement(mesh, structs) -> Sharded:
    """The `Sharded` placement of a params tree (``structs``: meta tensors
    will do, only shapes are read) on a `RankMesh` by these rules: each
    leaf's `param_spec`, the data axes, and `state_spec` of each
    `TrainState` leaf at its params leaf's whole shape (``step``: a
    scalar)."""
    shapes = {path_str(p): tuple(leaf.shape)
              for p, leaf in leaves_with_paths(structs)}

    def state_rule(path: str) -> tuple:
        return state_spec(path, shapes.get(path.partition("/")[2], ()), mesh)

    return Sharded(mesh, param_shardings(structs, mesh), shapes,
                   data_axes(mesh), state_rule)


def serve_placement(mesh, structs, cache) -> Sharded:
    """`placement` of a params tree for the serving steps, with the specs
    of a decode cache (``cache``: its whole leaves, meta tensors will do;
    an encoder-decoder's cross_k and cross_v at the source's own length)
    in both layouts, at ``cache/prefill/{name}`` and
    ``cache/decode/{name}`` (`cache_spec`, guarded where ``model`` does
    not divide W or Ss), and of the last-token logits (B, 1, V) at
    ``logits`` (`logits_spec`)."""
    tp = placement(mesh, structs)
    for kind in ("prefill", "decode"):
        for name, spec in cache_shardings(cache, mesh, kind).items():
            tp.specs[f"cache/{kind}/{name}"] = spec
            tp.shapes[f"cache/{kind}/{name}"] = tuple(cache[name].shape)
    shape = (cache["pos"].shape[0], 1, tp.shapes["embed"][0])
    tp.specs["logits"] = logits_spec(mesh, shape)
    tp.shapes["logits"] = shape
    return tp
