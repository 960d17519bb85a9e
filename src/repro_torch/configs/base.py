"""Config system: the model config and the registry of the port.

``ModelConfig`` is a copy of ``repro.configs.base.ModelConfig`` (same
fields, same defaults, same derived values). The registry holds the
architectures the port runs so far; any other raises.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (family-polymorphic).

    Only the fields relevant to a family are consumed by its model
    definition; the rest stay at their defaults.
    """

    name: str
    family: str                     # dense | ssm | moe | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention
    attn_bias: bool = False         # qwen2-style QKV bias
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q/k
    sliding_window: int = 0         # 0 -> full attention
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001  # load-balance loss weight
    moe_impl: str = "sorted"        # sorted | dense | local

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)

    # encoder-decoder
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # modality frontend stub: model consumes precomputed embeddings
    embed_input: bool = False

    # perf knobs of the reference (defaults = paper-faithful baseline)
    inner_remat: bool = False
    uniform_decode: bool = False

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat_policy: str = "dots"      # none | dots | full

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("ssm", "hybrid") and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Whether long-context decode (500k) is supported."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Parameter count from the port's parameter shapes."""
        from repro_torch.models import registry as model_registry

        return model_registry.param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        from repro_torch.models import registry as model_registry

        return model_registry.param_count(self, active_only=True)


#: the architectures the port runs so far
ARCH_IDS = [
    "llama3-8b",
    "falcon-mamba-7b",
    "hymba-1.5b",
    "qwen3-moe-30b-a3b",
    "granite-8b",
    "yi-34b",
    "qwen2-72b",
    "mixtral-8x22b",
    "internvl2-2b",
    "seamless-m4t-large-v2",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


class _Registry:
    def __init__(self):
        self._cache: dict[str, Any] = {}

    def _load(self, arch_id: str):
        if arch_id not in ARCH_IDS and arch_id not in map(_module_name, ARCH_IDS):
            raise KeyError(f"architecture {arch_id!r} is not ported yet "
                           f"(the port has {', '.join(ARCH_IDS)})")
        key = _module_name(arch_id)
        if key not in self._cache:
            self._cache[key] = importlib.import_module(
                f"repro_torch.configs.{key}")
        return self._cache[key]

    def get(self, arch_id: str) -> ModelConfig:
        return self._load(arch_id).CONFIG

    def get_smoke(self, arch_id: str) -> ModelConfig:
        return self._load(arch_id).SMOKE

    def all_ids(self) -> list[str]:
        return list(ARCH_IDS)


registry = _Registry()
