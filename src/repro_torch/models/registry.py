"""The uniform Model facade over the port's family modules."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import kv_cache as kvc
from repro_torch.models import lm, serialize


class Model:
    """init_params / prefill / decode_step / init_cache on one device.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    pass ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        lm.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_params(self, generator: torch.Generator | None = None):
        """Seeded params on this model's device (seed 0 by default)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return lm.init_params(generator, self.cfg, device=self.device)

    def prefill(self, params, batch, cache_len=None, plain=False):
        return lm.prefill(self.cfg, params, batch, cache_len=cache_len,
                          plain=plain)

    def decode_step(self, params, cache, token, plain=False):
        return lm.decode_step(self.cfg, params, cache, token, plain=plain)

    def init_cache(self, batch, seq_len, dtype=torch.bfloat16):
        return kvc.init_cache(self.cfg, batch, seq_len, dtype=dtype,
                              device=self.device)


def get_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)


def param_count(cfg: ModelConfig) -> int:
    """Parameter count from the meta-device param tree (no allocation)."""
    return sum(math.prod(x.shape)
               for x in serialize.leaves(lm.param_structs(cfg)))
