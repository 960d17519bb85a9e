from repro_torch.kernels.ssm_scan.ops import (selective_scan,
                                              selective_scan_bwd,
                                              selective_scan_states)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref, ssm_scan_ref_bwd

__all__ = ["selective_scan", "selective_scan_bwd", "selective_scan_states",
           "ssm_scan_ref", "ssm_scan_ref_bwd"]
