"""The uniform Model facade over the port's family modules."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm, serialize
from repro_torch.models import kv_cache as kvc


def _module(cfg: ModelConfig):
    """The family module: `encdec` for an encoder-decoder, else `lm`."""
    return encdec if cfg.is_encoder_decoder else lm


class Model:
    """init_params / loss / prefill / decode_step / init_cache on one
    device.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        lm.check_supported(cfg)
        self.cfg = cfg
        self._mod = _module(cfg)
        self.device = resolve_device(device)

    def init_params(self, generator: torch.Generator | None = None):
        """Seeded params on this model's device (seed 0 by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self._mod.init_params(generator, self.cfg, device=self.device)

    def loss(self, params, batch, plain=False, tp=None):
        """(loss, metrics) of one batch, differentiable in ``params``;
        ``tp`` places the step on a mesh (the family's
        ``forward_train``)."""
        return self._mod.forward_train(self.cfg, params, batch, plain=plain,
                                       tp=tp)

    def prefill(self, params, batch, cache_len=None, plain=False, tp=None):
        """The family's prefill; ``tp`` (a serving placement) runs it on
        a mesh, for every family: dense, vlm, moe, ssm, hybrid and
        enc-dec (`lm.check_mesh` raises only where ``model`` does not
        split the decode cache's head_dim or d_inner)."""
        lm.check_mesh(self.cfg, tp, serve=True)
        on_mesh = {} if tp is None else {"tp": tp}
        return self._mod.prefill(self.cfg, params, batch,
                                 cache_len=cache_len, plain=plain, **on_mesh)

    def decode_step(self, params, cache, token, plain=False, tp=None):
        """The family's decode step; ``tp`` as `prefill`'s."""
        lm.check_mesh(self.cfg, tp, serve=True)
        on_mesh = {} if tp is None else {"tp": tp}
        return self._mod.decode_step(self.cfg, params, cache, token,
                                     plain=plain, **on_mesh)

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16):
        return kvc.init_cache(self.cfg, batch, seq_len, dtype=dtype,
                              device=self.device)


def get_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)


def param_structs(cfg: ModelConfig):
    """The params tree of any family as meta tensors: shapes and dtypes,
    no data."""
    return _module(cfg).param_structs(cfg)


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from the meta-device param tree (no allocation).

    active_only: count only the top-k experts' share of the MoE FFN
    params, as the reference's does.
    """
    structs = param_structs(cfg)
    total = sum(math.prod(x.shape) for x in serialize.leaves(structs))
    if active_only and cfg.num_experts:
        # expert FFN leaves scale by k/E
        experts = structs["layers"]["moe"]
        e_total = sum(math.prod(experts[k].shape)
                      for k in ("w_gate", "w_up", "w_down"))
        total = (total - e_total
                 + e_total * cfg.num_experts_per_tok // cfg.num_experts)
    return total
