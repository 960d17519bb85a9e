"""Plain PyTorch version of the prefill attention kernel.

Mirrors ``repro.kernels.flash_attention.ref.attention_ref``: unblocked,
f32, masked scores -1e30, the softmax sum clamped at 1e-30. Queries are
taken in blocks of rows, as many as keep one block's f32 scores within
``SCORE_ELEMS``, so a long prompt (mixtral-8x22b's 8192 tokens over 48
heads would need 12.9 GB of scores, and several such temporaries) stays
within the card beside the weights. Each row's softmax is whole, so the
result is the unblocked one; short inputs take one block.
`mha_ref_with_lse` also returns each row's log-sum-exp of the masked
scores (the forward kernel's lse); `mha_ref_bwd` is the gradient by
autograd, the backward kernel's oracle.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: the most f32 scores one block of query rows may hold (1 GiB). The dry
#: run's meta passes set it past any cell for their duration
#: (`repro_torch.launch.dryrun.one_block`).
SCORE_ELEMS = 1 << 28


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd). Returns (B, H, Sq, hd)."""
    return _blocks(q, k, v, causal, window)[0]


def _blocks(q, k, v, causal, window):
    """`attention_ref`'s output and its rows' lse, (B, H, Sq) f32, in
    blocks of query rows."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    rows = max(1, SCORE_ELEMS // max(1, B * H * Sk))
    parts = [_rows(q[:, :, i:i + rows], k, v, i, causal, window)
             for i in range(0, Sq, rows)]
    return (torch.cat([o for o, _ in parts], dim=2),
            torch.cat([lse for _, lse in parts], dim=2))


def _rows(q, k, v, q0, causal, window):
    """Query rows q0 .. q0 + q.shape[2] of `attention_ref`, and their
    log-sum-exp m + log(max(l, 1e-30)) of the masked scores."""
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
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p / l
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    lse = (m + torch.log(l)).reshape(B, H, Sq)
    return o.reshape(B, H, Sq, hd).to(q.dtype), lse


def mha_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """`attention_ref` in the model's layout: q (B, S, H, hd); k, v
    (B, Sk, K, hd) -> (B, S, H, hd)."""
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)


def mha_ref_with_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """`mha_ref`'s output and each query row's log-sum-exp of the masked
    scaled scores, (B, H, Sq) f32: the plain version of `mha_with_lse`."""
    out, lse = _blocks(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal, window)
    return out.transpose(1, 2), lse


def mha_ref_bwd(q, k, v, out, dout, *, lse=None, causal: bool = True,
                window: int = 0):
    """The plain backward: dq, dk, dv of `mha_ref` at (q, k, v) for the
    output gradient ``dout``, by ``torch.autograd.grad``, in the inputs'
    dtypes. ``out`` and ``lse`` (the forward's output and row
    log-sum-exp) are taken for the kernel's signature and not read. The
    oracle of the backward kernel; nothing on the card's train path calls
    it."""
    del out, lse
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = mha_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, dout)
