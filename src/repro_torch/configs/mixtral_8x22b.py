"""Mixtral-8x22B — MoE, 8 experts top-2, sliding-window attention
[arXiv:2401.04088]. The assignment specifies SWA; window per Mixtral = 4096.
SWA makes the arch sub-quadratic, so ``long_500k`` runs with a
window-bounded KV cache.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,           # per-expert FFN width
    vocab_size=32_768,
    head_dim=128,
    rope_theta=1_000_000.0,
    sliding_window=4_096,
    num_experts=8,
    num_experts_per_tok=2,
)

SMOKE = CONFIG.replace(
    name="mixtral-8x22b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=64,
    num_experts=4,
    num_experts_per_tok=2,
)
