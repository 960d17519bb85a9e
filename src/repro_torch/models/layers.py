"""Shared model layers of the dense decoder: norms, RoPE, attention, MLP.

The counterpart of ``repro.models.layers`` (dense parts). Attention over
a sequence goes through the prefill kernel and one-token attention
through the decode kernel (``repro_torch.kernels``); on CPU tensors their
wrappers run the plain versions. ``plain=True`` asks for the plain
versions explicitly, on any device. `full_attention` and
`decode_attention` are the reference's plain layer functions, kept for
comparison. The reference's prefill switches to a blocked jnp path above
``S > 2048`` or with a sliding window (mixtral-8x22b); the kernel bounds
memory and masks the window itself, so that path has no counterpart
here.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_mha, decode_mha_ref
from repro_torch.kernels.flash_attention import mha, mha_ref

NEG_INF = -1e30


# ---------------------------------------------------------------- init utils

def dense_init(generator, shape, in_axis=0, dtype=torch.bfloat16, device=None):
    """LeCun-normal over the contracting dimension.

    ``device`` defaults to the generator's; on the meta device (no
    generator) it returns a struct of the right shape and dtype.
    """
    device = generator.device if device is None else device
    fan_in = shape[in_axis]
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


# --------------------------------------------------------------------- norms

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- RoPE

def rope_freqs(head_dim, theta, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                       # (hd/2,)


def apply_rope(x, positions, theta):
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S).

    Half-split rotation computed in f32, as in the reference.
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------- attention (core)

def _gqa_scores(q, k):
    """q: (B, Sq, K, G, hd), k: (B, Sk, K, hd) -> (B, K, G, Sq, Sk) f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_values(p, v):
    """p: (B, K, G, Sq, Sk); v: (B, Sk, K, hd) -> (B, Sq, K, G, hd) f32."""
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float())


def full_attention(q, k, v, mask):
    """Unblocked attention, the reference's plain layer function.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd); mask broadcastable to
    (B, 1, 1, Sq, Sk). Returns (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd) / math.sqrt(hd)
    s = torch.where(mask, _gqa_scores(qg, k), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, v).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, slot_pos, pos, *, window=0):
    """Single-token attention against a (ring) KV cache, the reference's
    plain layer function.

    q: (B, 1, H, hd); k_cache, v_cache: (B, W, K, hd);
    slot_pos: (B, W) absolute position stored in each slot (-1 = empty);
    pos: (B,) current absolute position of the query token.
    """
    B, _, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, 1, K, H // K, hd) / math.sqrt(hd)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, None, :], _gqa_scores(qg, k_cache),
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_values(p, v_cache).reshape(B, 1, H, hd).to(q.dtype)


# ------------------------------------------------------------ attention layer

def init_attention(generator, cfg, dtype, device=None):
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(generator, (D, H * hd), 0, dtype, device),
        "wk": dense_init(generator, (D, K * hd), 0, dtype, device),
        "wv": dense_init(generator, (D, K * hd), 0, dtype, device),
        "wo": dense_init(generator, (H * hd, D), 0, dtype, device),
    }
    device = generator.device if device is None else device
    if cfg.attn_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((K * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((K * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def _project_qkv(p, cfg, x):
    """q (B, S, H, hd), k and v (B, S, K, hd); with ``attn_bias`` the
    QKV bias is added after the products (Qwen2); with ``qk_norm`` q and
    k are RMS-normed over hd per head (Qwen3), before RoPE."""
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def attention_layer(p, cfg, x, *, plain=False):
    """Causal self-attention over a full sequence (prefill), positions
    from 0, a window from ``cfg.sliding_window``.

    Returns (out, (k, v)) so callers can build a KV cache.
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attend = mha_ref if plain else mha
    out = attend(q, k, v, causal=True, window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def attention_decode_layer(p, cfg, x, k_cache, v_cache, slot_pos, pos, *,
                           plain=False):
    """One-token self-attention against a ring cache.

    x: (B, 1, D); pos: (B,) absolute position of this token. ``slot_pos``
    must ALREADY include the current token (the stack updates it once).
    This layer's K/V are written into slot ``pos % W`` of ``k_cache`` and
    ``v_cache`` IN PLACE (the reference returns updated copies); returns
    (out, (k_cache, v_cache)).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    W = k_cache.shape[1]
    slot = (pos % W).long()
    b_idx = torch.arange(B, device=x.device)
    k_cache[b_idx, slot] = k[:, 0]
    v_cache[b_idx, slot] = v[:, 0]
    attend = decode_mha_ref if plain else decode_mha
    out = attend(q, k_cache, v_cache, slot_pos, pos, window=cfg.sliding_window)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], (k_cache, v_cache)


# ----------------------------------------------------------------------- MLP

def init_mlp(generator, d_model, d_ff, dtype, device=None):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), 0, dtype, device),
    }


def mlp_layer(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
