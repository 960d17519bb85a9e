from repro_torch.kernels.flash_attention.ops import mha, mha_bwd, mha_with_lse
from repro_torch.kernels.flash_attention.ref import (attention_ref, mha_ref,
                                                     mha_ref_bwd,
                                                     mha_ref_with_lse)

__all__ = ["attention_ref", "mha", "mha_bwd", "mha_ref", "mha_ref_bwd",
           "mha_ref_with_lse", "mha_with_lse"]
