"""Qwen3-30B-A3B — MoE, 128 experts top-8, q/k-norm [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,              # per-expert FFN width
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
)

SMOKE = CONFIG.replace(
    name="qwen3-moe-30b-a3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    num_experts=8,
    num_experts_per_tok=2,
)
