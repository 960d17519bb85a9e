"""Yi-34B — llama-architecture dense GQA decoder [arXiv:2403.04652; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20_480,
    vocab_size=64_000,
    head_dim=128,
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.replace(
    name="yi-34b-smoke",
    num_layers=2,
    d_model=112,
    num_heads=7,
    num_kv_heads=1,
    head_dim=16,
    d_ff=224,
    vocab_size=512,
)
