from repro_torch.kernels.decode_attention.ops import decode_mha
from repro_torch.kernels.decode_attention.ref import decode_mha_ref, decode_ref

__all__ = ["decode_mha", "decode_mha_ref", "decode_ref"]
