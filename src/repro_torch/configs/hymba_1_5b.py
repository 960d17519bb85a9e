"""Hymba-1.5B — hybrid head: parallel attention + Mamba within each layer
[arXiv:2411.13676; hf]. Attention heads use a sliding window (Hymba uses
SWA in all but 3 layers; we use SWA uniformly), so with the SSM branch
the arch is sub-quadratic and ``long_500k`` runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1_600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5_504,
    vocab_size=32_001,
    head_dim=64,
    sliding_window=2_048,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = CONFIG.replace(
    name="hymba-1.5b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    sliding_window=64,
    dt_rank=8,
)
