from repro_torch.kernels.decode_attention.ops import (decode_mha,
                                                      decode_scores_hd,
                                                      decode_values_hd)
from repro_torch.kernels.decode_attention.ref import (decode_mha_ref,
                                                      decode_ref,
                                                      decode_scores_hd_ref,
                                                      decode_values_hd_ref)

__all__ = ["decode_mha", "decode_mha_ref", "decode_ref", "decode_scores_hd",
           "decode_scores_hd_ref", "decode_values_hd", "decode_values_hd_ref"]
