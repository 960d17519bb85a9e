"""Meta-tensor stand-ins for every model input.

The counterpart of ``repro.launch.specs``: where the reference builds
``jax.ShapeDtypeStruct``s, these are tensors on the meta device, with
shapes and dtypes and no data, which is what the dry run (`dryrun`)
places on a mesh and runs the step on. Shapes come from the assignment's
four regimes; the modality-frontend archs (vlm / audio) get precomputed
embedding stand-ins, as the reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import kv_cache as kvc
from repro_torch.models import registry


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        # audio frontend stub: precomputed frame embeddings, 1 frame/token
        return {
            "src_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
            "tgt_tokens": _meta((B, S), torch.int32),
            "targets": _meta((B, S), torch.int32),
        }
    if cfg.embed_input:
        return {
            "inputs_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
            "targets": _meta((B, S), torch.int32),
        }
    return {
        "tokens": _meta((B, S), torch.int32),
        "targets": _meta((B, S), torch.int32),
    }


def prefill_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        return {
            "src_embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
            "tgt_tokens": _meta((B, S), torch.int32),
        }
    if cfg.embed_input:
        return {"inputs_embeds": _meta((B, S, cfg.d_model), torch.bfloat16)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_cache_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The decode cache for a seq_len-deep context (no allocation)."""
    return kvc.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")


def decode_token_spec(cfg: ModelConfig, shape: InputShape):
    return _meta((shape.global_batch, 1), torch.int32)


def param_specs(cfg: ModelConfig) -> dict:
    return registry.param_structs(cfg)
