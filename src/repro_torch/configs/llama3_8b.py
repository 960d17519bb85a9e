"""Llama-3-8B — dense GQA decoder, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
)

SMOKE = CONFIG.replace(
    name="llama3-8b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
