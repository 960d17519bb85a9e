"""Falcon-Mamba-7B — attention-free Mamba-1 SSM [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4_096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,        # unused (attention-free)
    d_ff=0,            # mamba block subsumes the MLP
    vocab_size=65_024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-7b-smoke",
    num_layers=2,
    d_model=128,
    vocab_size=512,
    dt_rank=8,
)
