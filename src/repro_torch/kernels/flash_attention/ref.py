"""Plain PyTorch version of the prefill attention kernel.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: unblocked,
f32, masked scores -1e30, the softmax sum clamped at 1e-30.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd). Returns (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, hd).to(q.dtype)


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """`attention_ref` in the model's layout: q (B, S, H, hd); k, v
    (B, Sk, K, hd) -> (B, S, H, hd)."""
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)
