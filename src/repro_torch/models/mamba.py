"""Mamba-1 selective-SSM block (Falcon-Mamba, and Hymba's SSM branch).

The counterpart of ``repro.models.mamba``. Params keep the reference's
leaf names and dtypes (A_log and D_skip in f32), so the codec writes the
same bytes. Over a sequence `mamba_layer` runs the selective scan through
the hand-written kernel (``repro_torch.kernels.ssm_scan``); on CPU
tensors its wrapper runs the plain version, and ``plain=True`` runs
`ssm_scan_chunked`, the reference's chunked scan, on any device. One
decode step has no kernel in the reference, so none here either.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models.layers import dense_init

SCAN_CHUNK = 128


def init_mamba(generator, cfg, dtype, device=None):
    D, di, N, R, c = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    device = generator.device if device is None else device
    # S4D-real initialization for A: A_log = log(1..N) per channel, the
    # correctly rounded f32 values on every machine (XLA's f32 log can be
    # one ulp off: its log(7) is)
    a_log = torch.tensor([math.log(n) for n in range(1, N + 1)],
                         dtype=torch.float32)
    a_init = a_log.to(device).repeat(di, 1)
    return {
        "in_proj": dense_init(generator, (D, 2 * di), 0, dtype, device),
        "conv_w": dense_init(generator, (c, di), 0, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, (di, R + 2 * N), 0, dtype, device),
        "dt_proj": dense_init(generator, (R, di), 0, dtype, device),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": a_init,                                  # (di, N) f32
        "D_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, (di, D), 0, dtype, device),
    }


def softplus(x):
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv1d. x: (B, S, di); w: (c, di).

    conv_state: (B, c-1, di) previous tail, or None for zero history.
    Returns (y, new_state). The taps are summed in x's dtype in the
    reference's order.
    """
    B, S, di = x.shape
    c = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, c - 1, di))
    xx = torch.cat([conv_state.to(x.dtype), x], dim=1)  # (B, S+c-1, di)
    y = sum(xx[:, i:i + S] * w[i] for i in range(c)) + b
    return y, xx[:, xx.shape[1] - (c - 1):]               # last c-1 inputs


def ssm_scan_chunked(dt, xr, Bmat, Cmat, A, h0, chunk=SCAN_CHUNK):
    """Selective scan h_t = exp(dt_t*A)*h_{t-1} + dt_t*B_t*x_t, emitting
    y_t = <h_t, C_t>, chunk by chunk: the model path's plain version.

    Inside a chunk a doubling scan with the reference's combine
    (a1 + a2, b1 * exp(a2) + b2) gives every step's state from the
    chunk's first; only (B, chunk, di, N) is ever materialised, never
    (B, S, di, N). The last chunk may be short (no padding).

    dt: (B, S, di) f32; xr: (B, S, di); Bmat, Cmat: (B, S, N) f32;
    A: (di, N) f32 negative; h0: (B, di, N) f32.
    Returns (y (B, S, di) f32, h_final (B, di, N) f32).
    """
    S = dt.shape[1]
    h = h0.float()
    ys = []
    for t0 in range(0, S, chunk):
        dtc = dt[:, t0:t0 + chunk]
        da = dtc[..., None] * A                          # (B,c,di,N) <= 0
        dbx = ((dtc * xr[:, t0:t0 + chunk].float())[..., None]
               * Bmat[:, t0:t0 + chunk, None, :])
        L = da.shape[1]
        k = 1
        while k < L:
            a_prev, b_prev = da[:, :L - k], dbx[:, :L - k]
            a_cur, b_cur = da[:, k:], dbx[:, k:]
            da = torch.cat([da[:, :k], a_prev + a_cur], dim=1)
            dbx = torch.cat([dbx[:, :k], b_prev * torch.exp(a_cur) + b_cur],
                            dim=1)
            k *= 2
        h_all = dbx + h[:, None] * torch.exp(da)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all,
                               Cmat[:, t0:t0 + chunk]))
        h = h_all[:, -1]
    y = torch.cat(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


def mamba_layer(p, cfg, x, state=None, *, plain=False):
    """Full-sequence Mamba block. x: (B, S, D).

    state: {'conv': (B,c-1,di), 'ssm': (B,di,N)} or None.
    Returns (y (B,S,D), new_state) with the conv state in bf16.
    """
    B, S, _ = x.shape
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xr, z = (x @ p["in_proj"]).chunk(2, dim=-1)          # (B,S,di) each
    conv_in = state["conv"] if state is not None else None
    xr, conv_state = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_in)
    xr = F.silu(xr)

    proj = (xr @ p["x_proj"]).float()                    # (B,S,R+2N)
    dt_r, Bmat, Cmat = proj.split([R, N, N], dim=-1)     # strided views
    dt = softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])                           # (di,N) negative

    h0 = (state["ssm"] if state is not None
          else torch.zeros((B, di, N), dtype=torch.float32, device=x.device))
    scan = ssm_scan_chunked if plain else selective_scan
    y, h_final = scan(dt, xr, Bmat, Cmat, A, h0)
    y = y + p["D_skip"] * xr.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"conv": conv_state.to(torch.bfloat16),
                               "ssm": h_final}


def mamba_decode_step(p, cfg, x, state):
    """One-token Mamba step. x: (B, 1, D). O(1) in context length.

    Returns (out (B, 1, D), new_state); the caller writes the state back.
    """
    N, R = cfg.ssm_state, cfg.dt_rank
    xr, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)    # (B, di) each

    conv = state["conv"].to(xr.dtype)                    # (B, c-1, di)
    window = torch.cat([conv, xr[:, None]], dim=1)       # (B, c, di)
    xr = torch.einsum("bcd,cd->bd", window, p["conv_w"]) + p["conv_b"]
    xr = F.silu(xr)

    proj = (xr @ p["x_proj"]).float()                    # (B, R+2N)
    dt_r, Bmat, Cmat = proj.split([R, N, N], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)                    # (B, di, N)
    dBx = (dt * xr.float())[..., None] * Bmat[:, None, :]
    h = state["ssm"] * dA + dBx                          # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, Cmat)
    y = y + p["D_skip"] * xr.float()
    y = y.to(x.dtype) * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    return out, {"conv": window[:, 1:].to(torch.bfloat16), "ssm": h}
