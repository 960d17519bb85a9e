"""KV and SSM cache containers.

The counterpart of ``repro.models.kv_cache``: plain dicts of tensors with
a leading layer axis. ``slot_pos`` holds the absolute position stored in
each ring slot (-1 = empty), which makes masking exact for full and ring
caches alike. The SSM families keep a bf16 conv tail and an f32 state
per layer; the ssm family has no ``slot_pos``.
"""
from __future__ import annotations

import torch

ATTN_FAMILIES = ("dense", "vlm", "moe", "audio", "hybrid")
SSM_FAMILIES = ("ssm", "hybrid")


def cache_width(cfg, seq_len: int) -> int:
    """Ring-buffer width: full seq for dense, window-bounded for SWA."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_attn_cache(cfg, batch, seq_len, dtype=torch.bfloat16,
                    device="cpu"):
    L = cfg.num_layers
    W = cache_width(cfg, seq_len)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((L, batch, W, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((L, batch, W, K, hd), dtype=dtype, device=device),
    }


def init_ssm_cache(cfg, batch, device="cpu"):
    """The conv tail in bf16 whatever the model's dtype, as the
    reference's `mamba_layer` and `mamba_decode_step` return it; the state
    in f32."""
    L = cfg.num_layers
    di, N, c = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((L, batch, c - 1, di), dtype=torch.bfloat16,
                            device=device),
        "ssm": torch.zeros((L, batch, di, N), dtype=torch.float32,
                           device=device),
    }


def init_cross_cache(cfg, batch, src_len, dtype=torch.bfloat16,
                     device="cpu"):
    """Cross-attention K/V over the encoded source, per decoder layer."""
    shape = (cfg.num_layers, batch, src_len, cfg.num_kv_heads, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device="cpu"):
    """Full decode cache for one model instance; an encoder-decoder's
    cross K/V are ``seq_len`` wide, as the reference's."""
    if cfg.family not in ATTN_FAMILIES + SSM_FAMILIES:
        raise NotImplementedError(f"{cfg.family} caches are not ported")
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family in ATTN_FAMILIES:
        cache.update(init_attn_cache(cfg, batch, seq_len, dtype=dtype,
                                     device=device))
        W = cache_width(cfg, seq_len)
        cache["slot_pos"] = torch.full((batch, W), -1, dtype=torch.int32,
                                       device=device)
    if cfg.family in SSM_FAMILIES:
        cache.update(init_ssm_cache(cfg, batch, device=device))
    if cfg.is_encoder_decoder:
        cache.update(init_cross_cache(cfg, batch, seq_len, dtype=dtype,
                                      device=device))
    return cache


def write_prefill_entries(cache_k, k):
    """Write prefill K (B, S, K, hd) into a ring cache (B, W, K, hd).

    Writes IN PLACE and returns ``cache_k`` (the reference returns an
    updated copy).
    """
    W = cache_k.shape[1]
    S = k.shape[1]
    if S <= W:
        cache_k[:, :S] = k
        return cache_k
    # keep the last W positions (ring layout: slot = pos % W)
    slots = torch.arange(S - W, S, device=k.device) % W
    cache_k[:, slots] = k[:, S - W:]
    return cache_k


def prefill_slot_pos(seq_len, width, batch, device="cpu"):
    """slot_pos after a prefill of ``seq_len`` tokens into width-W ring."""
    slots = torch.arange(width, device=device)
    if seq_len <= width:
        pos = torch.where(slots < seq_len, slots, -1)
    else:
        last = seq_len - 1
        # slot s holds the largest position p <= last with p % W == s
        pos = last - ((last - slots) % width)
    return pos.to(torch.int32).expand(batch, width).contiguous()
