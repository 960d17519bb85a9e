"""Deterministic flat tensor-tree codec, byte-identical to the reference's.

The same wire format as ``repro.models.serialize``: the leaves of a tree
in `jax.tree_util` flatten order (dict keys sorted, tuples and lists in
position order, ``None`` holding no leaf), each as its raw C-contiguous
little-endian buffer, concatenated. No header, no padding. bf16 leaves
travel as their raw 2-byte words. The reader supplies a tree of leaves
with ``.shape`` and ``.dtype`` (meta tensors from `struct`, or real
tensors), so every size and offset is known before a payload exists.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: the leaf dtypes of the trees the port carries (params, caches, tokens)
#: -> the numpy dtype their raw words are read as
_WORDS = {
    torch.float32: np.float32,
    torch.bfloat16: np.int16,
    torch.int32: np.int32,
}


def leaves(tree) -> list:
    """Leaves in `jax.tree_util` flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _unflatten(tree, it):
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _unflatten(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(t, it) for t in tree)
    return next(it)


def unflatten(tree, flat: list):
    """A tree of ``tree``'s structure whose leaves are ``flat``, given in
    `leaves` order."""
    return _unflatten(tree, iter(flat))


def struct(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype leaf that holds no data (a meta tensor)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def leaf_nbytes(leaf) -> int:
    """Size in bytes of one tensor or struct leaf."""
    return math.prod(leaf.shape) * leaf.dtype.itemsize


def tree_nbytes(shapes) -> int:
    """Total encoded size of a tree of structs (or tensors)."""
    return sum(leaf_nbytes(x) for x in leaves(shapes))


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def dumps(tree) -> bytes:
    """Encode a tree of tensors to its canonical flat byte string."""
    return b"".join(_leaf_bytes(x) for x in leaves(tree))


def loads(shapes, data, device="cpu"):
    """Decode ``data`` against a tree of structs.

    Returns a tree of the same structure with tensor leaves on
    ``device``. Raises ``ValueError`` on any size mismatch: a truncated
    or padded payload is never silently reinterpreted.
    """
    specs = leaves(shapes)
    for spec in specs:
        if spec.dtype not in _WORDS:
            raise TypeError(f"no codec for leaf dtype {spec.dtype}")
    total = sum(leaf_nbytes(x) for x in specs)
    buf = memoryview(data)
    if len(buf) != total:
        raise ValueError(
            f"payload is {len(buf)}B but the declared tree needs {total}B")
    out, off = [], 0
    for spec in specs:
        n = leaf_nbytes(spec)
        words = np.frombuffer(buf[off:off + n], dtype=_WORDS[spec.dtype])
        t = torch.from_numpy(words.copy()).reshape(tuple(spec.shape))
        if spec.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        out.append(t.to(device))
        off += n
    return _unflatten(shapes, iter(out))
