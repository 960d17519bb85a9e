"""InternVL2-2B — VLM: InternViT frontend (STUB) + InternLM2 backbone
[arXiv:2404.16821; hf].

Only the transformer BACKBONE is modeled; the vision frontend is a stub:
the model takes precomputed patch embeddings of shape (batch, seq,
d_model) as ``inputs_embeds``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8_192,
    vocab_size=92_553,
    head_dim=128,
    rope_theta=1_000_000.0,
    embed_input=True,
)

SMOKE = CONFIG.replace(
    name="internvl2-2b-smoke",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
