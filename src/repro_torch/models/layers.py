"""Shared model layers: norms, RoPE, sinusoid positions, attention, MLP.

The counterpart of ``repro.models.layers``. Attention over a sequence
(self-attention, bidirectional or causal, and cross-attention) goes
through the prefill kernel and one-token attention (self or cross)
through the decode kernel (``repro_torch.kernels``); on CPU tensors
their wrappers run the plain versions. ``plain=True`` asks for the plain
versions explicitly, on any device. `full_attention`, `decode_attention`
and `blocked_causal_attention` are the reference's plain layer
functions, kept for comparison: the reference's prefill takes the
blocked one above ``S > 2048`` or with a sliding window, where the
port's prefill runs the kernel, which bounds memory and masks the window
itself. Nothing on the kernel path calls them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.decode_attention import (decode_mha, decode_mha_ref,
                                                  decode_scores_hd,
                                                  decode_scores_hd_ref,
                                                  decode_values_hd,
                                                  decode_values_hd_ref)
from repro_torch.kernels.flash_attention import mha, mha_ref
from repro_torch.parallel import collectives as C

NEG_INF = -1e30
#: the stacked leaves a decoder-only model's tensor-parallel layers fetch
#: their weights from (`Sharded.weight` paths); an encoder-decoder's live
#: under ``enc_layers/`` and ``dec_layers/``, its cross-attention's at
#: ``XATTN``
ATTN, MLP = "layers/attn", "layers/mlp"
XATTN = "dec_layers/xattn"


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


def sinusoid_pos_embed(positions, d_model):
    """Absolute sinusoidal embeddings (enc-dec archs), in f32.
    positions: (...,) -> (..., d_model)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def blocked_causal_attention(q, k, v, *, window=0, q_block=512,
                             kv_block=512, q_offset=0, causal=True,
                             inner_remat=False):
    """Flash-style blocked attention in plain tensor ops, the reference's
    plain layer function, with Python loops over the blocks.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H = K * G. ``window`` > 0
    masks a sliding window and bounds the kv blocks visited per q block,
    from a first block that, as in the reference, does not shift with
    ``q_offset`` (the absolute position of q[:, 0]; k positions start at
    0). ``causal=False`` gives bidirectional attention. Sq and Sk are
    padded to whole blocks and the padded keys masked. With
    ``inner_remat`` and grad enabled each q block's body and each kv
    block's step run under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint`` of ``q_step`` and ``kv_step``): the backward pass
    recomputes them instead of keeping their scores; the values are the
    same. Returns (B, Sq, H, hd) in q.dtype.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    pad_q, pad_k = (-Sq) % q_block, (-Sk) % kv_block
    q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = q.shape[1] // q_block, k.shape[1] // kv_block
    qb = q.reshape(B, nq, q_block, K, G, hd)
    kb = k.reshape(B, nk, kv_block, K, hd)
    vb = v.reshape(B, nk, kv_block, K, hd)
    if window > 0:            # the kv blocks a q block can ever need
        nk_needed = min(nk, -(-(window + q_block) // kv_block) + 1)
    else:
        nk_needed = nk
    k_pos_base = torch.arange(kv_block, device=q.device)
    remat = inner_remat and torch.is_grad_enabled()

    def kv_step(m, l, acc, q_i, q_pos, j):
        k_pos = j * kv_block + k_pos_base
        s = _gqa_scores(q_i, kb[:, j])                   # (B, K, G, qc, kc)
        mask = (k_pos < Sk)[None, :]                     # kv padding
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vb[:, j].float())
        return m_new, l, acc

    def q_step(qi):
        q_i = qb[:, qi] * scale                          # (B, qc, K, G, hd)
        q_pos = q_offset + qi * q_block + torch.arange(q_block,
                                                       device=q.device)
        first = 0
        if window > 0:        # the earliest kv block visible to this block
            lo = max(qi * q_block + q_block - 1
                     - (window - 1 + kv_block - 1), 0)
            first = min(lo // kv_block, max(nk - nk_needed, 0))
        m = torch.full((B, K, G, q_block), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, q_block), device=q.device)
        acc = torch.zeros((B, K, G, q_block, hd), device=q.device)
        for j in range(first, first + nk_needed):
            if remat:
                m, l, acc = checkpoint(kv_step, m, l, acc, q_i, q_pos, j,
                                       use_reentrant=False)
            else:
                m, l, acc = kv_step(m, l, acc, q_i, q_pos, j)
        out = acc / l.clamp_min(1e-30)[..., None]        # (B, K, G, qc, hd)
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)

    outs = [checkpoint(q_step, qi, use_reentrant=False) if remat
            else q_step(qi) for qi in range(nq)]
    out = torch.cat(outs, dim=1).reshape(B, nq * q_block, H, hd)
    return out[:, :Sq]


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


def attention_layer(p, cfg, x, *, use_rope=True, causal=True, plain=False,
                    tp=None, path=ATTN):
    """Self-attention over a full sequence (prefill, encoder), positions
    from 0, a window from ``cfg.sliding_window``; ``causal=False`` is
    bidirectional (the encoder's), ``use_rope=False`` leaves q and k
    unrotated (the enc-dec archs add sinusoid positions to x instead).
    With ``tp`` (a `repro_torch.parallel.placement.Sharded` on a mesh of
    more than one rank) the layer runs on this rank's heads
    (`_attention_on_mesh`), its weights fetched from the stacked leaves
    under ``path`` (``"enc_layers/attn"``, ``"dec_layers/attn"``).

    Returns (out, (k, v)) so callers can build a KV cache.
    """
    if tp is not None:
        return _attention_on_mesh(p, cfg, x, tp, use_rope, causal, plain,
                                  path)
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    if use_rope:
        positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    attend = mha_ref if plain else mha
    out = attend(q, k, v, causal=causal, window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def _kv_for_heads(k, v, h0, h1, G, k0):
    """k, v (B, S, Kl, hd) of kv heads k0.. for the q heads [h0, h1):
    as they are where those q heads are whole groups or share one kv
    head, else one kv head per q head (the kernels map q head j to kv
    head j // (Hl / Kl))."""
    aligned = h0 % G == 0 and h1 % G == 0
    if aligned or k.shape[2] == 1:
        return k, v
    idx = torch.tensor([h // G - k0 for h in range(h0, h1)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


class MeshHeads(NamedTuple):
    """One ``model`` rank's heads on a mesh: its q heads [h0, h1), the kv
    heads they read [k0, k1), and those of them no rank before it reads
    [o0, o1) (each kv head is sent to the caches by one rank)."""

    h0: int
    h1: int
    k0: int
    k1: int
    o0: int
    o1: int


def mesh_heads(tp, cfg) -> list[MeshHeads]:
    """Every ``model`` rank's `MeshHeads`, in coordinate order: q heads
    ``tp.splits(H)``, kv heads the groups they fall in."""
    G = cfg.num_heads // cfg.num_kv_heads
    out, seen = [], 0
    for h0, h1 in tp.splits(cfg.num_heads):
        k0 = h0 // G
        k1 = (h1 - 1) // G + 1 if h1 > h0 else k0
        o0 = max(k0, seen)
        o1 = max(k1, o0)
        seen = max(seen, k1)
        out.append(MeshHeads(h0, h1, k0, k1, o0, o1))
    return out


def _head_cols(p, cfg, tp, path, name, lo, hi):
    """Heads [lo, hi) of the attention weight or bias ``name`` (its last
    dim H * hd or K * hd) of the stacked leaf under ``path``."""
    leaf, hd = p[name], cfg.head_dim
    return tp.weight(leaf, f"{path}/{name}", leaf.dim() - 1, lo * hd, hi * hd)


def _project_on_mesh(p, cfg, x, tp, hs: MeshHeads, path=ATTN):
    """q (B, S, h1 - h0, hd), k and v (B, S, k1 - k0, hd) of this rank's
    heads: column-parallel q/k/v (and QKV bias) on x entering the split
    (`Sharded.copy`), q/k norms replicated; no RoPE."""
    B, S, _ = x.shape
    hd = cfg.head_dim

    def cols(name, lo, hi):
        return _head_cols(p, cfg, tp, path, name, lo, hi)

    xp = tp.copy(x)
    q, k, v = xp @ cols("wq", hs.h0, hs.h1), xp @ cols("wk", hs.k0, hs.k1), \
        xp @ cols("wv", hs.k0, hs.k1)
    if cfg.attn_bias:
        q = q + cols("bq", hs.h0, hs.h1)
        k = k + cols("bk", hs.k0, hs.k1)
        v = v + cols("bv", hs.k0, hs.k1)
    q = q.reshape(B, S, hs.h1 - hs.h0, hd)
    k = k.reshape(B, S, hs.k1 - hs.k0, hd)
    v = v.reshape(B, S, hs.k1 - hs.k0, hd)
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy(p["q_norm"]), cfg.norm_eps)
        k = rms_norm(k, tp.copy(p["k_norm"]), cfg.norm_eps)
    return q, k, v


def _out_on_mesh(p, cfg, out, tp, hs: MeshHeads, path=ATTN):
    """Row-parallel ``wo`` on this rank's heads' outputs (B, S, h1 - h0,
    hd), summed over ``model`` (`Sharded.reduce`)."""
    B, S = out.shape[:2]
    hd = cfg.head_dim
    wo = tp.weight(p["wo"], f"{path}/wo", 0, hs.h0 * hd, hs.h1 * hd)
    return tp.reduce(out.reshape(B, S, (hs.h1 - hs.h0) * hd) @ wo)


def _attention_on_mesh(p, cfg, x, tp, use_rope, causal, plain, path=ATTN):
    """`attention_layer` on this rank's q heads [h0, h1) of H (its
    ``model`` share) and the kv heads [k0, k1) they read
    (`_project_on_mesh`), the attention kernel on the local heads,
    row-parallel ``wo`` summed over ``model`` (`_out_on_mesh`). The FSDP
    dims of each weight are gathered over the data axes where it is
    read. Returns (out, (k, v)) with k and v of kv heads [k0, k1)."""
    B, S, _ = x.shape
    G = cfg.num_heads // cfg.num_kv_heads
    hs = mesh_heads(tp, cfg)[tp.mesh.coords["model"]]
    q, k, v = _project_on_mesh(p, cfg, x, tp, hs, path)
    if use_rope:
        positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kq, vq = _kv_for_heads(k, v, hs.h0, hs.h1, G, hs.k0)
    attend = mha_ref if plain else mha
    out = attend(q, kq, vq, causal=causal, window=cfg.sliding_window)
    return _out_on_mesh(p, cfg, out, tp, hs, path), (k, v)


def _write_slot(cfg, k_cache, v_cache, k, v, pos, tp=None):
    """This token's k and v (B, 1, K, d) into slot ``pos % W`` of the
    caches (B, W, K, d), in place; with ``cfg.uniform_decode`` every row
    into the slot of the batch's first row (on a mesh the global first
    row's: the first data rank's)."""
    B, W = k_cache.shape[:2]
    if cfg.uniform_decode:
        first = pos[:1]
        if tp is not None and tp.mesh.group(tp.data) is not None:
            first = tp.gather_data(first).reshape(-1)[:1]
        slot0 = (first % W).long()
        k_cache.index_copy_(1, slot0, k)
        v_cache.index_copy_(1, slot0, v)
    else:
        slot = (pos % W).long()
        b_idx = torch.arange(B, device=k.device)
        k_cache[b_idx, slot] = k[:, 0]
        v_cache[b_idx, slot] = v[:, 0]


def attention_decode_layer(p, cfg, x, k_cache, v_cache, slot_pos, pos, *,
                           use_rope=True, plain=False, tp=None, path=ATTN):
    """One-token self-attention against a ring cache.

    x: (B, 1, D); pos: (B,) absolute position of this token. ``slot_pos``
    must ALREADY include the current token (the stack updates it once).
    This layer's K/V are written into slot ``pos % W`` of ``k_cache`` and
    ``v_cache`` IN PLACE (the reference returns updated copies); returns
    (out, (k_cache, v_cache)). With ``cfg.uniform_decode`` the rows decode
    in lockstep and every row writes slot ``pos[0] % W``, as the
    reference's does: where rows stand at other positions, the cache and
    ``slot_pos`` (stamped per row by the stack) disagree in both packages
    alike. With ``tp`` (a serving placement) the caches are this rank's
    shards of the decode layout, head_dim over ``model``
    (`_attention_decode_on_mesh`; ``path`` as `attention_layer`'s).
    """
    if tp is not None:
        return _attention_decode_on_mesh(p, cfg, x, k_cache, v_cache,
                                         slot_pos, pos, tp, use_rope, plain,
                                         path)
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    _write_slot(cfg, k_cache, v_cache, k, v, pos)
    attend = decode_mha_ref if plain else decode_mha
    out = attend(q, k_cache, v_cache, slot_pos, pos, window=cfg.sliding_window)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ p["wo"], (k_cache, v_cache)


def _attention_decode_on_mesh(p, cfg, x, k_cache, v_cache, slot_pos, pos,
                              tp, use_rope, plain, path=ATTN):
    """`attention_decode_layer` on a mesh whose caches (B, W, K, hd /
    model) hold a head_dim slice of every head (the reference's decode
    layout): q, k and v of this rank's heads (`_project_on_mesh`), RoPE
    on whole heads, then one ``all_to_all`` over ``model`` each of k and
    v to the slice of every head (from the rank that is first to hold
    each kv head); the slot written in place; the attention on the
    slices (`_attend_hd_on_mesh`) and row-parallel ``wo``. The serving
    steps' `lm.check_mesh` has made sure that ``model`` splits
    head_dim."""
    heads = mesh_heads(tp, cfg)
    hs = heads[tp.mesh.coords["model"]]
    q, k, v = _project_on_mesh(p, cfg, x, tp, hs, path)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    own = slice(hs.o0 - hs.k0, hs.o1 - hs.k0)
    counts = [r.o1 - r.o0 for r in heads]
    k = C.all_to_all(k[:, 0, own], tp.mesh, "model", 2, 1, recv=counts)
    v = C.all_to_all(v[:, 0, own], tp.mesh, "model", 2, 1, recv=counts)
    _write_slot(cfg, k_cache, v_cache, k[:, None], v[:, None], pos, tp)
    out = _attend_hd_on_mesh(q[:, 0], k_cache, v_cache, slot_pos, pos,
                             cfg.sliding_window, tp, heads, plain)
    return _out_on_mesh(p, cfg, out[:, None], tp, hs, path), (k_cache,
                                                               v_cache)


def _attend_hd_on_mesh(q, k_cache, v_cache, slot_pos, pos, window, tp,
                       heads, plain):
    """The output (B, h1 - h0, hd) of this rank's heads for their q
    (B, h1 - h0, hd) against caches that hold a head_dim slice of every
    head (B, W, K, hd / model): one ``all_to_all`` over ``model`` sends q
    to the slice of every head, the partial scores (`decode_scores_hd`)
    are summed over ``model`` in f32 (counted as "score_all_reduce"), the
    softmax and values (`decode_values_hd`) run on the sums and an
    ``all_to_all`` sends the result back to the rank's heads. At
    ``model`` 1 the one-device kernel (`decode_mha`) runs on the whole
    heads."""
    hd = q.shape[-1]
    counts = [r.h1 - r.h0 for r in heads]
    q = C.all_to_all(q, tp.mesh, "model", 2, 1, recv=counts)  # (B, H, hd/M)
    if tp.mesh.shape["model"] == 1:
        attend = decode_mha_ref if plain else decode_mha
        return attend(q[:, None], k_cache, v_cache, slot_pos, pos,
                      window=window)[:, 0]
    scores, values = ((decode_scores_hd_ref, decode_values_hd_ref)
                      if plain else (decode_scores_hd, decode_values_hd))
    s = C.all_reduce(scores(q, k_cache), tp.mesh, "model",
                     kind="score_all_reduce")
    out = values(s, v_cache, slot_pos, pos, head_dim=hd,
                 window=window)                               # (B, H, hd/M)
    return C.all_to_all(out, tp.mesh, "model", 1, 2, send=counts)


def _cross_query(p, cfg, x):
    """q from ``wq`` alone: no bias and no q-norm, as the reference's."""
    B, S, _ = x.shape
    return (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)


def cross_attention_layer(p, cfg, x, k, v, *, plain=False, tp=None):
    """Cross-attention of x (B, St, D) against the encoder's K/V
    (B, Ss, K, hd), unmasked: the prefill kernel, bidirectional, with
    Sq = St and Sk = Ss. With ``tp`` (on a mesh) k and v are this rank's
    kv heads [k0, k1) (`mesh_heads`), q comes from its ``wq`` columns
    under ``XATTN`` and the row-parallel ``wo`` is summed over
    ``model``."""
    B, S, _ = x.shape
    attend = mha_ref if plain else mha
    if tp is None:
        out = attend(_cross_query(p, cfg, x), k, v, causal=False, window=0)
        return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]
    hs = mesh_heads(tp, cfg)[tp.mesh.coords["model"]]
    q = (tp.copy(x) @ _head_cols(p, cfg, tp, XATTN, "wq", hs.h0, hs.h1)
         ).reshape(B, S, hs.h1 - hs.h0, cfg.head_dim)
    G = cfg.num_heads // cfg.num_kv_heads
    kq, vq = _kv_for_heads(k, v, hs.h0, hs.h1, G, hs.k0)
    out = attend(q, kq, vq, causal=False, window=0)
    return _out_on_mesh(p, cfg, out, tp, hs, XATTN)


def cross_kv_on_mesh(p, cfg, enc_out, tp):
    """This rank's kv heads [k0, k1) (`mesh_heads`) of the cross K/V
    (B, Ss, k1 - k0, hd): the encoder's output (whole on every rank of
    ``model``) on the rank's ``wk`` and ``wv`` columns under ``XATTN``."""
    B, Ss, _ = enc_out.shape
    hs = mesh_heads(tp, cfg)[tp.mesh.coords["model"]]
    xp = tp.copy(enc_out)
    return tuple((xp @ _head_cols(p, cfg, tp, XATTN, name, hs.k0, hs.k1)
                  ).reshape(B, Ss, hs.k1 - hs.k0, cfg.head_dim)
                 for name in ("wk", "wv"))


def cross_attention_decode_layer(p, cfg, x, k, v, every_slot, last, *,
                                 plain=False, tp=None):
    """One token's cross-attention (x: (B, 1, D)) against the encoder's
    K/V (B, Ss, K, hd) through the decode kernel: ``every_slot`` is
    (B, Ss) int32 ``arange(Ss)`` and ``last`` (B,) int32 ``Ss - 1``, so
    every slot is valid and the kernel computes the reference's unmasked
    attention. With ``tp`` (a serving placement) k and v are this rank's
    shards of the decode layout, a head_dim slice of every head: q of
    the rank's heads from its ``wq`` columns under ``XATTN`` attends on
    the slices (`_attend_hd_on_mesh`) and row-parallel ``wo`` follows;
    nothing is written into k and v."""
    B = x.shape[0]
    if tp is None:
        attend = decode_mha_ref if plain else decode_mha
        out = attend(_cross_query(p, cfg, x), k, v, every_slot, last,
                     window=0)
        return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]
    heads = mesh_heads(tp, cfg)
    hs = heads[tp.mesh.coords["model"]]
    q = tp.copy(x[:, 0]) @ _head_cols(p, cfg, tp, XATTN, "wq", hs.h0, hs.h1)
    out = _attend_hd_on_mesh(q.reshape(B, hs.h1 - hs.h0, cfg.head_dim), k,
                             v, every_slot, last, 0, tp, heads, plain)
    return _out_on_mesh(p, cfg, out[:, None], tp, hs, XATTN)


# ----------------------------------------------------------------------- MLP

def init_mlp(generator, d_model, d_ff, dtype, device=None):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(generator, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), 0, dtype, device),
    }


def mlp_layer(p, x, tp=None, path=MLP):
    """SwiGLU. With ``tp`` (`attention_layer`'s) on this rank's
    ``model`` share of the d_ff columns: column-parallel gate and up,
    row-parallel down summed over ``model``, the weights fetched from
    the stacked leaves under ``path``."""
    if tp is None:
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    f0, f1 = tp.split(tp.shape(f"{path}/w_down", p["w_down"].dim())[0])
    xp = tp.copy(x)
    gate = tp.weight(p["w_gate"], f"{path}/w_gate", 1, f0, f1)
    up = tp.weight(p["w_up"], f"{path}/w_up", 1, f0, f1)
    down = tp.weight(p["w_down"], f"{path}/w_down", 0, f0, f1)
    return tp.reduce((F.silu(xp @ gate) * (xp @ up)) @ down)
