"""Analytic MODEL_FLOPS per (arch x shape): the roofline's 'useful
compute' reference and the MLServe calibration's cost input.

A copy of ``repro.models.flops``, the arithmetic in the same order, so
every value is equal as a float. `repro_torch.core.calibrate` derives
the committed calibration from it.

Conventions (per the assignment):
* train:   6 * N * D   (N = params, D = tokens; MoE: N_active)
           + exact attention-score flops (which 6ND omits),
* prefill: 2 * N * D + attention,
* decode:  2 * N * B per token + attention over the live cache.

Attention score/value flops per layer: 4 * B * S_q * S_kv_eff * H * hd
(QK^T + PV, x2 mul-add), causal halves S_kv_eff, sliding windows cap it.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.kv_cache import cache_width


def _attn_flops_layer(cfg: ModelConfig, B: int, Sq: int, Skv: int,
                      causal: bool = True) -> float:
    if cfg.attn_free:
        return 0.0
    window = cfg.sliding_window
    if window:
        s_eff = min(window, Skv) if Sq == 1 else min(window, Skv) * Sq
    else:
        s_eff = Skv if Sq == 1 else (Sq * Skv / 2 if causal else Sq * Skv)
    H, hd = cfg.num_heads, cfg.head_dim
    return 4.0 * B * s_eff * H * hd


def _ssm_flops_layer(cfg: ModelConfig, B: int, S: int) -> float:
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    di, N = cfg.d_inner, cfg.ssm_state
    # recurrence + y-contraction: ~8 flops per (t, channel, state)
    return 8.0 * B * S * di * N


def model_flops(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    N_active = cfg.active_param_count()
    L = cfg.num_layers

    if shape.kind == "train":
        D = B * S
        core = 6.0 * N_active * D
        attn = 3.0 * L * _attn_flops_layer(cfg, B, S, S)   # fwd + 2x bwd
        ssm = 3.0 * L * _ssm_flops_layer(cfg, B, S)
        if cfg.is_encoder_decoder:
            attn *= 2.0                                    # enc + cross
    elif shape.kind == "prefill":
        D = B * S
        core = 2.0 * N_active * D
        attn = L * _attn_flops_layer(cfg, B, S, S)
        ssm = L * _ssm_flops_layer(cfg, B, S)
        if cfg.is_encoder_decoder:
            attn *= 2.0
    else:  # decode: one token against a seq_len cache
        core = 2.0 * N_active * B
        attn = L * _attn_flops_layer(cfg, B, 1, S)
        ssm = L * _ssm_flops_layer(cfg, B, 1)
        if cfg.is_encoder_decoder:
            attn *= 2.0

    return {"core": core, "attention": attn, "ssm": ssm,
            "total": core + attn + ssm}


def hbm_bytes_ideal(cfg: ModelConfig, shape: InputShape,
                    devices: int = 256) -> float:
    """Ideal per-device HBM traffic: params read once (sharded) +
    activations in/out once per layer + cache traffic (decode)."""
    B, S = shape.global_batch, shape.seq_len
    pbytes = cfg.param_count() * 2 / devices             # bf16, sharded
    if shape.kind == "train":
        pbytes *= 3                                       # fwd + bwd + opt
        act = cfg.num_layers * B * S * cfg.d_model * 2 * 4 / devices
        return pbytes + act
    if shape.kind == "prefill":
        act = cfg.num_layers * B * S * cfg.d_model * 2 * 2 / devices
        return pbytes + act
    # decode: stream the KV cache (or SSM state) once
    if cfg.attn_free:
        cache = cfg.num_layers * B * cfg.d_inner * cfg.ssm_state * 4
    else:
        W = cache_width(cfg, S)
        cache = (cfg.num_layers * B * W * cfg.num_kv_heads
                 * cfg.head_dim * 2 * 2)
        if cfg.family == "hybrid":
            cache += cfg.num_layers * B * cfg.d_inner * cfg.ssm_state * 4
    return pbytes + cache / devices
