"""Qwen2-72B — dense GQA decoder with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = CONFIG.replace(
    name="qwen2-72b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
