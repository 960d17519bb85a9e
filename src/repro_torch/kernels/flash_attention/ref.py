"""Plain PyTorch version of the prefill attention kernel.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: unblocked,
f32, masked scores -1e30, the softmax sum clamped at 1e-30. Queries are
taken in blocks of rows, as many as keep one block's f32 scores within
``SCORE_ELEMS``, so a long prompt (mixtral-8x22b's 8192 tokens over 48
heads would need 12.9 GB of scores, and several such temporaries) stays
within the card beside the weights. Each row's softmax is whole, so the
result is the unblocked one; short inputs take one block.
`mha_ref_bwd` is its gradient by autograd, the backward kernel's oracle.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: the most f32 scores one block of query rows may hold (1 GiB)
SCORE_ELEMS = 1 << 28


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd). Returns (B, H, Sq, hd)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    rows = max(1, SCORE_ELEMS // max(1, B * H * Sk))
    return torch.cat([_rows(q[:, :, i:i + rows], k, v, i, causal, window)
                      for i in range(0, Sq, rows)], dim=2)


def _rows(q, k, v, q0, causal, window):
    """Query rows q0 .. q0 + q.shape[2] of `attention_ref`."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Sq, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float())
    q_pos = torch.arange(q0, q0 + Sq, device=q.device)[:, None]
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


def mha_ref_bwd(q, k, v, out, dout, *, causal: bool = True, window: int = 0):
    """The plain backward: dq, dk, dv of `mha_ref` at (q, k, v) for the
    output gradient ``dout``, by ``torch.autograd.grad``, in the inputs'
    dtypes. ``out`` (the forward's output) is taken for the kernel's
    signature and not read. The oracle of the backward kernel; nothing on
    the card's train path calls it."""
    del out
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = mha_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, dout)
