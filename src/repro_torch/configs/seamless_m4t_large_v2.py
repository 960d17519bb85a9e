"""SeamlessM4T-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596; hf].

The audio frontend is a STUB: the encoder takes precomputed frame
embeddings (batch, src_len, d_model) as ``src_embeds``. The text decoder
is a standard causal transformer with cross-attention; its decode step
runs against self- and cross-attention caches.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,              # decoder layers
    num_encoder_layers=24,
    d_model=1_024,
    num_heads=16,
    num_kv_heads=16,            # kv=16 -> MHA
    d_ff=8_192,
    vocab_size=256_206,
    head_dim=64,
    is_encoder_decoder=True,
    embed_input=True,           # encoder input = precomputed frame embeddings
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke",
    num_layers=2,
    num_encoder_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)
