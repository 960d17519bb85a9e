from repro_torch.kernels.ssm_scan.ops import selective_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["selective_scan", "ssm_scan_ref"]
