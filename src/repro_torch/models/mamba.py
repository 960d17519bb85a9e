"""Mamba-1 selective-SSM block (Falcon-Mamba, and Hymba's SSM branch).

The counterpart of ``repro.models.mamba``. Params keep the reference's
leaf names and dtypes (A_log and D_skip in f32), so the codec writes the
same bytes. Over a sequence `mamba_layer` runs the selective scan through
the hand-written kernel (``repro_torch.kernels.ssm_scan``), which with
grad is an autograd Function with its own backward kernel; on CPU
tensors its wrapper runs the plain versions, and ``plain=True`` runs
`ssm_scan_chunked`, the reference's chunked scan (checkpointed per chunk
under ``cfg.inner_remat``, as the reference's), on any device. One
decode step has no kernel in the reference, so none here either.

On a mesh (``tp``, a `repro_torch.parallel.placement.Sharded` of more
than one rank) `mamba_layer` runs on this rank's ``model`` share of the
d_inner channels, the scan and its backward kernel on those channels
alone, and so does `mamba_decode_step` (a serving placement), whose
state is then the rank's shard of the decode cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models.layers import dense_init
from repro_torch.parallel import collectives as C

#: steps a chunk of `ssm_scan_chunked` takes. The dry run's meta passes
#: set it past any sequence for their duration
#: (`repro_torch.launch.dryrun.one_block`), so it is read at each call.
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


def _chunk_step(h, dtc, xrc, bc, cc, A):
    """One chunk of `ssm_scan_chunked`: (y (B, c, di), the state after
    the chunk's last step) from the state before its first."""
    da = dtc[..., None] * A                              # (B,c,di,N) <= 0
    dbx = (dtc * xrc.float())[..., None] * bc[:, :, None, :]
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
    return torch.einsum("bsdn,bsn->bsd", h_all, cc), h_all[:, -1]


def ssm_scan_chunked(dt, xr, Bmat, Cmat, A, h0, chunk=None,
                     inner_remat=False):
    """Selective scan h_t = exp(dt_t*A)*h_{t-1} + dt_t*B_t*x_t, emitting
    y_t = <h_t, C_t>, chunk by chunk: the model path's plain version.

    Inside a chunk a doubling scan with the reference's combine
    (a1 + a2, b1 * exp(a2) + b2) gives every step's state from the
    chunk's first; only (B, chunk, di, N) is ever materialised, never
    (B, S, di, N). ``chunk`` defaults to ``SCAN_CHUNK``, read at the
    call. The last chunk may be short (no padding). With
    ``inner_remat`` and grad enabled each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    chunk step): autograd keeps only each chunk's inputs and state, and
    the backward pass recomputes the chunk's (B, chunk, di, N) tensors;
    the values are the same.

    dt: (B, S, di) f32; xr: (B, S, di); Bmat, Cmat: (B, S, N) f32;
    A: (di, N) f32 negative; h0: (B, di, N) f32.
    Returns (y (B, S, di) f32, h_final (B, di, N) f32).
    """
    S = dt.shape[1]
    chunk = chunk or SCAN_CHUNK
    remat = inner_remat and torch.is_grad_enabled()
    h = h0.float()
    ys = []
    for t0 in range(0, S, chunk):
        ins = (h, dt[:, t0:t0 + chunk], xr[:, t0:t0 + chunk],
               Bmat[:, t0:t0 + chunk], Cmat[:, t0:t0 + chunk], A)
        y, h = (checkpoint(_chunk_step, *ins, use_reentrant=False) if remat
                else _chunk_step(*ins))
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else dt.new_zeros(dt.shape)
    return y, h


def _same(t):
    return t


def _channels(p, di, tp):
    """(c0, c1, chan, copy, reduce) of this rank's share of the block:
    its channels [c0, c1) of d_inner (``tp.split``), ``chan(name, dim)``
    the leaf's range along its d_inner ``dim`` (this rank's own shard on
    a mesh, the leaf itself off it), and Megatron's f and g over
    ``model`` (the identity off the mesh)."""
    if tp is None:
        return 0, di, lambda name, dim: p[name], _same, _same
    c0, c1 = tp.split(di)

    def chan(name, dim):
        return tp.weight(p[name], f"layers/mamba/{name}", dim, c0, c1)
    return c0, c1, chan, tp.copy, tp.reduce


def mamba_layer(p, cfg, x, state=None, *, plain=False, tp=None):
    """Full-sequence Mamba block. x: (B, S, D).

    state: {'conv': (B,c-1,di), 'ssm': (B,di,N)} or None.
    Returns (y (B,S,D), new_state) with the conv state in bf16.

    With ``tp`` (training or a prefill on a mesh; no state) the block
    runs on this
    rank's channels [c0, c1) of d_inner (``tp.split``; the reference's
    hints put ``xr`` and ``dt`` over ``model`` on d_inner) and the new
    state holds those channels only. ``in_proj``'s columns are
    ``[x | z]``, so a rank's channels are a range of each half, never its
    own shard: one gather of the leaf over ``model`` a pass (counted),
    both ranges cut from it, on x entering the split (`Sharded.copy`).
    The conv, its bias, ``dt_proj``, ``dt_bias``, ``A_log`` and
    ``D_skip`` are this rank's own shards. ``x_proj`` is row-parallel:
    the partial products summed over ``model`` give every rank the whole
    dt_r, B and C, which then enter channel-split work through
    `Sharded.copy`, so their gradients (the scan's dB and dC, d(dt_r)
    through ``dt_proj``: sums over this rank's channels) are summed over
    ``model`` there, not in the kernel. The scan runs on (B, S, di / M)
    with the whole (B, S, N) B and C; ``out_proj`` is row-parallel,
    summed over ``model``. Without ``tp`` every fetch is the leaf itself
    and the sums are the identity.
    """
    B, S, _ = x.shape
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    c0, c1, chan, copy, reduce = _channels(p, di, tp)
    if tp is None:
        xr, z = (x @ p["in_proj"]).chunk(2, dim=-1)      # (B,S,di) each
    else:
        xp = copy(x)
        w_x, w_z = tp.weight_ranges(p["in_proj"], "layers/mamba/in_proj", 1,
                                    ((c0, c1), (di + c0, di + c1)))
        xr, z = xp @ w_x, xp @ w_z                       # (B,S,di/M) each
    conv_in = state["conv"] if state is not None else None
    xr, conv_state = _causal_conv(xr, chan("conv_w", 1), chan("conv_b", 0),
                                  conv_in)
    xr = F.silu(xr)

    proj = copy(reduce((xr @ chan("x_proj", 0)).float()))  # (B,S,R+2N)
    dt_r, Bmat, Cmat = proj.split([R, N, N], dim=-1)     # strided views
    dt = softplus(dt_r @ chan("dt_proj", 1).float()
                  + chan("dt_bias", 0).float())
    A = -torch.exp(chan("A_log", 0))                     # (di,N) negative

    h0 = (state["ssm"] if state is not None
          else torch.zeros((B, c1 - c0, N), dtype=torch.float32,
                           device=x.device))
    if plain:
        y, h_final = ssm_scan_chunked(dt, xr, Bmat, Cmat, A, h0,
                                      inner_remat=cfg.inner_remat)
    else:
        y, h_final = selective_scan(dt, xr, Bmat, Cmat, A, h0)
    y = y + chan("D_skip", 0) * xr.float()
    y = y.to(x.dtype) * F.silu(z)
    return reduce(y @ chan("out_proj", 0)), {
        "conv": conv_state.to(torch.bfloat16), "ssm": h_final}


def _in_proj_on_mesh(p, cfg, x, tp, c0, c1):
    """This rank's x and z channels [c0, c1) of the one-token ``in_proj``
    product (x: (B, D)) without gathering the leaf over ``model``: x
    times this rank's own column shard [o0, o0 + 2 di / M) of the
    (D, 2 di) leaf, then one ``all_to_all`` over ``model`` (counted as
    "in_proj_all_to_all", (B, 2 di / M) elements a rank) sends each rank
    the columns of its x range [j0, j1) and z range [di + j0, di + j1),
    uneven parts where the ranges straddle shards. The columns arrive in
    the senders' order, which is the columns' own, so x's range comes
    before z's. Each column's dot product over D is the gathered
    path's."""
    di = cfg.d_inner
    part = 2 * di // tp.mesh.shape["model"]

    def overlaps(o0, j0, j1):
        """[lo, hi) of the columns [o0, o0 + part) in j's x and z
        ranges, x's first."""
        return [(max(lo, o0), min(hi, o0 + part))
                for lo, hi in ((j0, j1), (di + j0, di + j1))
                if min(hi, o0 + part) > max(lo, o0)]

    o0 = tp.mesh.coords["model"] * part
    y = x @ tp.weight(p["in_proj"], "layers/mamba/in_proj", 1, o0, o0 + part)
    pieces, send = [], []
    for j0, j1 in tp.splits(di):
        cols = overlaps(o0, j0, j1)
        pieces += [y[:, lo - o0:hi - o0] for lo, hi in cols]
        send.append(sum(hi - lo for lo, hi in cols))
    recv = [sum(hi - lo for lo, hi in overlaps(i * part, c0, c1))
            for i in range(len(send))]
    xz = C.all_to_all(torch.cat(pieces, dim=1), tp.mesh, "model", 1, 1,
                      send=send, recv=recv, kind="in_proj_all_to_all")
    return xz.split(c1 - c0, dim=1)


def mamba_decode_step(p, cfg, x, state, tp=None):
    """One-token Mamba step. x: (B, 1, D). O(1) in context length.

    Returns (out (B, 1, D), new_state); the caller writes the state back.

    With ``tp`` (a serving placement) the step runs on this rank's
    channels [c0, c1) of d_inner, as `mamba_layer` does, and ``state``
    and the new state are the rank's shards of the decode cache
    ((B, c-1, di / M) and (B, di / M, N)): the x and z channels from
    this rank's own ``in_proj`` columns and one exchange
    (`_in_proj_on_mesh`; a gather of the leaf would move (D, 2 di / M) a
    layer a step), the conv taps, ``dt_proj``, ``dt_bias``, ``A_log``
    and ``D_skip`` as this rank's own shards, ``x_proj`` and
    ``out_proj`` row-parallel, summed over ``model``.
    """
    N, R = cfg.ssm_state, cfg.dt_rank
    c0, c1, chan, copy, reduce = _channels(p, cfg.d_inner, tp)
    if tp is None:
        xr, z = (x[:, 0] @ p["in_proj"]).chunk(2, dim=-1)    # (B, di) each
    else:
        xr, z = _in_proj_on_mesh(p, cfg, copy(x[:, 0]), tp, c0, c1)

    conv = state["conv"].to(xr.dtype)                    # (B, c-1, di)
    window = torch.cat([conv, xr[:, None]], dim=1)       # (B, c, di)
    xr = (torch.einsum("bcd,cd->bd", window, chan("conv_w", 1))
          + chan("conv_b", 0))
    xr = F.silu(xr)

    proj = reduce((xr @ chan("x_proj", 0)).float())      # (B, R+2N)
    dt_r, Bmat, Cmat = proj.split([R, N, N], dim=-1)
    dt = softplus(dt_r @ chan("dt_proj", 1).float()
                  + chan("dt_bias", 0).float())
    A = -torch.exp(chan("A_log", 0))
    dA = torch.exp(dt[..., None] * A)                    # (B, di, N)
    dBx = (dt * xr.float())[..., None] * Bmat[:, None, :]
    h = state["ssm"] * dA + dBx                          # (B, di, N)
    y = torch.einsum("bdn,bn->bd", h, Cmat)
    y = y + chan("D_skip", 0) * xr.float()
    y = y.to(x.dtype) * F.silu(z)
    out = reduce(y @ chan("out_proj", 0))[:, None]
    return out, {"conv": window[:, 1:].to(torch.bfloat16), "ssm": h}
