"""Plain PyTorch versions of the selective-scan kernels.

`ssm_scan_ref` mirrors ``repro.kernels.ssm_scan.ref.ssm_scan_ref``: the
naive sequential recurrence in f32, one time step after another.
`ssm_scan_ref_bwd` is its gradient, the reverse-time recurrence written
out step by step (the reference differentiates its chunked scan with
XLA's autodiff; it has no backward kernel).
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


def ssm_scan_ref_bwd(dt, xr, Bmat, Cmat, A, h0, dy, dh_final=None):
    """The gradients of `ssm_scan_ref` at (dt, xr, Bmat, Cmat, A, h0),
    given dy (B, S, di) for y and dh_final (B, di, N) for h_final (None:
    zero). With a_t = exp(dt_t A), b_t = dt_t x_t B_t and
    g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1} (g_S adds dh_final):

      dC_t = sum_d dy_t h_t          dB_t = sum_d g_t dt_t x_t
      d(dt)_t = sum_n g_t (A a_t h_{t-1} + x_t B_t)
      dx_t = sum_n g_t dt_t B_t      dA = sum_{b,t} g_t dt_t a_t h_{t-1}
      dh0 = a_1 g_1

    in f32, from the forward's states kept step by step. Returns (d(dt),
    dx in xr's dtype, dB, dC, dA, dh0)."""
    xdtype = xr.dtype
    dt, xr, Bmat, Cmat = dt.float(), xr.float(), Bmat.float(), Cmat.float()
    A, dy = A.float(), dy.float()
    B, S, di = dt.shape
    hs = [h0.float()]                                    # h_{t-1} of step t
    for t in range(S):
        da = torch.exp(dt[:, t, :, None] * A)
        hs.append(hs[-1] * da + (dt[:, t] * xr[:, t])[..., None]
                  * Bmat[:, t, None, :])
    carry = (torch.zeros_like(hs[0]) if dh_final is None
             else dh_final.float().clone())              # a_{t+1} g_{t+1}
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(Bmat), torch.zeros_like(Cmat)
    dA = torch.zeros_like(A)
    for t in range(S - 1, -1, -1):
        dt_t, x_t, b_t = dt[:, t], xr[:, t], Bmat[:, t, None, :]
        da = torch.exp(dt_t[..., None] * A)              # a_t
        g = dy[:, t, :, None] * Cmat[:, t, None, :] + carry
        ah = da * hs[t]                                  # a_t h_{t-1}
        dC[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(dim=1)
        dB[:, t] = (g * (dt_t * x_t)[..., None]).sum(dim=1)
        ddt[:, t] = (g * (A * ah + x_t[..., None] * b_t)).sum(dim=-1)
        dx[:, t] = (g * b_t).sum(dim=-1) * dt_t
        dA += (g * dt_t[..., None] * ah).sum(dim=0)
        carry = da * g
    return ddt, dx.to(xdtype), dB, dC, dA, carry
