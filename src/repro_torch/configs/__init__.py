from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    InputShape,
    ModelConfig,
    all_cells,
    cell_is_runnable,
    registry,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "InputShape",
    "ModelConfig",
    "all_cells",
    "cell_is_runnable",
    "registry",
]
