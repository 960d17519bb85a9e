"""Plain PyTorch version of the selective-scan kernel.

Mirrors ``repro.kernels.ssm_scan.ref.ssm_scan_ref``: the naive
sequential recurrence in f32, one time step after another.
"""
from __future__ import annotations

import torch


def ssm_scan_ref(dt, xr, Bmat, Cmat, A, h0):
    """dt, xr: (B, S, di); Bmat, Cmat: (B, S, N); A: (di, N);
    h0: (B, di, N). Returns (y (B, S, di) f32, h_final (B, di, N) f32)."""
    dt, xr, Bmat, Cmat = dt.float(), xr.float(), Bmat.float(), Cmat.float()
    A = A.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t]                                  # (B, di)
        da = torch.exp(dt_t[..., None] * A)              # (B, di, N)
        dbx = (dt_t * xr[:, t])[..., None] * Bmat[:, t, None, :]
        h = h * da + dbx
        ys.append((h * Cmat[:, t, None, :]).sum(dim=-1))  # (B, di)
    y = torch.stack(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h
