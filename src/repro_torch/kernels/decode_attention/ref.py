"""Plain PyTorch version of the decode attention kernel.

Mirrors ``repro.kernels.decode_attention.ref.decode_ref``: ring-cache
masking from ``slot_pos``, f32, masked scores -1e30, the softmax sum
clamped at 1e-30.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_ref(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """q: (B, H, 1, hd); caches: (B, K, W, hd); slot_pos: (B, W);
    pos: (B,). Returns (B, H, 1, hd)."""
    B, H, _, hd = q.shape
    K = k_cache.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgw,bkwd->bkgd", p, v_cache.float())
    return o.reshape(B, H, 1, hd).to(q.dtype)


def decode_mha_ref(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """`decode_ref` in the model's layout: q (B, 1, H, hd); caches
    (B, W, K, hd) -> (B, 1, H, hd)."""
    return decode_ref(q.transpose(1, 2), k_cache.transpose(1, 2),
                      v_cache.transpose(1, 2), slot_pos, pos,
                      window=window).transpose(1, 2)
