"""Carry the reference's arrays across: numpy trees -> the port's trees.

The JAX package's params and caches reach the port as numpy arrays
(``np.asarray`` of each leaf). A bf16 leaf then has numpy dtype
``bfloat16`` (from ml_dtypes); it is read here as raw 16-bit words, so
the port needs no ml_dtypes. Trees keep their structure and leaf names.
"""
from __future__ import annotations

import numpy as np
import torch

#: the keys of a decode cache, by family
CACHE_KEYS = {
    "dense": ("k", "v", "slot_pos", "pos"),
    "ssm": ("pos", "conv", "ssm"),
    "hybrid": ("k", "v", "slot_pos", "pos", "conv", "ssm"),
    "encdec": ("pos", "k", "v", "slot_pos", "cross_k", "cross_v"),
}


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_numpy(tree, device="cpu"):
    """A tree of numpy arrays (dicts, tuples, lists) as torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def cache_from_numpy(cache: dict, device="cpu") -> dict:
    """A decode cache as torch tensors: dense, vlm and moe (k, v,
    slot_pos, pos), ssm (pos, conv, ssm), hybrid (those six) or encdec
    (pos, k, v, slot_pos, cross_k, cross_v)."""
    for keys in CACHE_KEYS.values():
        if set(cache) == set(keys):
            return {k: tensor_from_numpy(cache[k], device) for k in keys}
    raise ValueError(f"a decode cache has the keys of one of "
                     f"{list(CACHE_KEYS.values())}, got {sorted(cache)}")
