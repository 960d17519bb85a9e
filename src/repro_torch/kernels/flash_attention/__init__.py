from repro_torch.kernels.flash_attention.ops import mha, mha_bwd
from repro_torch.kernels.flash_attention.ref import (attention_ref, mha_ref,
                                                     mha_ref_bwd)

__all__ = ["attention_ref", "mha", "mha_bwd", "mha_ref", "mha_ref_bwd"]
