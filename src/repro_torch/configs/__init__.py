from repro_torch.configs.base import ARCH_IDS, ModelConfig, registry

__all__ = ["ARCH_IDS", "ModelConfig", "registry"]
