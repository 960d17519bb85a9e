"""Granite-8B-Code — llama-architecture dense GQA decoder [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=10_000_000.0,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    name="granite-8b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
