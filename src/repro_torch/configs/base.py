"""Config system: model configs, input shapes, the registry and the cells.

``ModelConfig``, ``InputShape``, ``SHAPES``, ``ARCH_IDS``,
`cell_is_runnable` and `all_cells` are copies of the reference's
``repro.configs.base`` (same fields, defaults, values and order). The
registry resolves an arch id ("qwen2-72b") or module name ("qwen2_72b")
to its ``CONFIG`` (the published dims) or ``SMOKE`` (a reduced config of
the same family for CPU tests); any other name raises.
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


@dataclass(frozen=True)
class InputShape:
    """One (named) input-shape regime from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shape regimes (identical across the 10 archs).
SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen2-72b",
    "llama3-8b",
    "yi-34b",
    "granite-8b",
    "falcon-mamba-7b",
    "internvl2-2b",
    "qwen3-moe-30b-a3b",
    "mixtral-8x22b",
    "seamless-m4t-large-v2",
    "hymba-1.5b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


class _Registry:
    def __init__(self):
        self._cache: dict[str, Any] = {}

    def _load(self, arch_id: str):
        if arch_id not in ARCH_IDS and arch_id not in map(_module_name, ARCH_IDS):
            raise KeyError(f"architecture {arch_id!r} is not ported "
                           f"(the registry has {', '.join(ARCH_IDS)})")
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


def cell_is_runnable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Whether an (arch x shape) dry-run cell runs: long_500k needs
    sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn): long_500k needs sub-quadratic attention"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    """All 40 nominal (arch_id, shape_name) cells in assignment order."""
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
