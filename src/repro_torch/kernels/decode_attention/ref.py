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


def decode_scores_hd_ref(q, k_cache):
    """The partial scores of a head_dim slice: q (B, H, hd_s), k_cache
    (B, W, K, hd_s) -> (B, H, W) f32, q . k over the slice, unscaled,
    every slot (the kernel ``decode_scores_hd``)."""
    B, H, hs = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hs).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k_cache.float())
    return s.reshape(B, H, W)


def decode_values_hd_ref(scores, v_cache, slot_pos, pos, *, head_dim: int,
                         window: int = 0):
    """Softmax and values on a head_dim slice: ``scores`` (B, H, W) f32,
    the full q . k summed over every slice; v_cache (B, W, K, hd_s) ->
    (B, H, hd_s) in v_cache's dtype. The scale is 1/sqrt(``head_dim``),
    the full head_dim; the slots' validity, the masked -1e30 and the sum
    clamped at 1e-30 are `decode_ref`'s (the kernel
    ``decode_values_hd``)."""
    B, H, W = scores.shape
    K, hs = v_cache.shape[2], v_cache.shape[3]
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, :], scores.float() / math.sqrt(head_dim),
                    NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgw,bwkd->bkgd", p.reshape(B, K, H // K, W),
                     v_cache.float())
    return o.reshape(B, H, hs).to(v_cache.dtype)
