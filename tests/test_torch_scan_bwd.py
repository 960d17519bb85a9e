"""The selective scan's backward on the CPU.

The reference trains through its chunked scan
(``repro.models.mamba.ssm_scan_chunked``) and XLA's autodiff; the port
has a hand-written backward kernel (``csrc/ssm_scan_bwd.cu``, tested on
the card in tests/test_torch_cuda.py). Here, on inputs made from numpy
seeds:

* the plain backward `ssm_scan_ref_bwd` is held to ``jax.vjp`` of the
  reference's ``ssm_scan_chunked`` and to ``torch.autograd`` of the
  port's `ssm_scan_ref`: each gradient within 1e-4 of its largest
  |value| in f32, and dx within 2e-2 where xr is bf16;
* `design_scan_bwd` repeats the kernel's arithmetic in plain PyTorch:
  the forward's states at every ``CHUNK``-th step, the intervals and
  their sub-chunks walked from the last, each recomputed
  once for its decays and rebuilt group by group from them, the sums over
  a channel's states per thread and then over its lanes for a group of
  steps (the reduce-scatter's pairing), the sums over channels per warp,
  then over a block's warps in order, a cluster's blocks in rank order and
  the clusters in order, and the masked tail of S and of di up to whole
  clusters (block counts that are not a multiple of the cluster). It is
  held to
  ``jax.vjp`` at the same tolerances, and two runs give the same bits;
* the autograd Function `_SelectiveScan` on CPU tensors: gradients only
  where ``needs_input_grad`` asks, a None dh_final, dx in xr's dtype, B
  and C as column views of one projection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import mamba as RM
from repro_torch.kernels.ssm_scan import (selective_scan, selective_scan_bwd,
                                          selective_scan_states, ssm_scan_ref,
                                          ssm_scan_ref_bwd)
from repro_torch.kernels.ssm_scan import ops as scan_ops

F32_TOL, BF16_DX_TOL = 1e-4, 2e-2
GRADS = ("ddt", "dx", "dB", "dC", "dA", "dh0")
THREADS, WARPS = 128, 4                   # the backward kernel's block
MAX_CLUSTER = 8                           # ... and its largest cluster
CHUNK = scan_ops.CHUNK
LOG2E = 1.4426950408889634


def scan_inputs(seed, B, S, di, N, *, h0_scale=0.5, long_memory=False,
                rank=0, dh_final=True):
    """dt, xr, B, C, A, h0, dy and dh_final (or None) as numpy f32; with
    ``long_memory`` the model's dt = softplus(z - 4.6) ~ 0.01 and
    A = -(1..N); B and C the columns ``rank`` onwards of one (B, S,
    rank + 2N) projection."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, S, di))
    if long_memory:
        dt = np.logaddexp(z - 4.6, 0.0)
        A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float64), (di, N))
    else:
        dt = np.logaddexp(z, 0.0) * 0.1
        A = -np.exp(rng.standard_normal((di, N)) * 0.5)
    xr = rng.standard_normal((B, S, di))
    proj = rng.standard_normal((B, S, rank + 2 * N))
    h0 = rng.standard_normal((B, di, N)) * h0_scale
    dy = rng.standard_normal((B, S, di))
    dhf = rng.standard_normal((B, di, N)) if dh_final else None
    f32 = (lambda a: None if a is None
           else np.ascontiguousarray(a, np.float32))
    return {"dt": f32(dt), "xr": f32(xr), "proj": f32(proj), "A": f32(A),
            "h0": f32(h0), "dy": f32(dy), "dhf": f32(dhf), "rank": rank,
            "N": N}


def torch_args(d, xdtype=torch.float32):
    """(dt, xr, Bmat, Cmat, A, h0) as tensors, B and C views of proj."""
    proj = torch.from_numpy(d["proj"])
    r, N = d["rank"], d["N"]
    return (torch.from_numpy(d["dt"]), torch.from_numpy(d["xr"]).to(xdtype),
            proj[..., r:r + N], proj[..., r + N:], torch.from_numpy(d["A"]),
            torch.from_numpy(d["h0"]))


def jax_grads(d, xdtype=torch.float32):
    """``jax.vjp`` of the reference's chunked scan at these inputs."""
    r, N = d["rank"], d["N"]
    jx = jnp.bfloat16 if xdtype == torch.bfloat16 else jnp.float32
    args = (jnp.asarray(d["dt"]), jnp.asarray(d["xr"]).astype(jx),
            jnp.asarray(d["proj"][..., r:r + N]),
            jnp.asarray(d["proj"][..., r + N:]), jnp.asarray(d["A"]),
            jnp.asarray(d["h0"]))
    _, vjp = jax.vjp(RM.ssm_scan_chunked, *args)
    dhf = d["dhf"] if d["dhf"] is not None else np.zeros_like(d["h0"])
    return vjp((jnp.asarray(d["dy"]), jnp.asarray(dhf)))


def torch_autograd_grads(d, xdtype=torch.float32):
    """torch.autograd of the port's plain forward at these inputs."""
    leaves = [t.detach().clone().requires_grad_(True)
              for t in torch_args(d, xdtype)]
    y, h = ssm_scan_ref(*leaves)
    dhf = (torch.from_numpy(d["dhf"]) if d["dhf"] is not None
           else torch.zeros_like(h))
    return torch.autograd.grad((y, h), leaves,
                               (torch.from_numpy(d["dy"]), dhf))


def assert_grads(got, want, xdtype=torch.float32):
    for name, a, b in zip(GRADS, got, want):
        a = np.asarray(torch.as_tensor(a).float() if isinstance(a, torch.Tensor)
                       else np.asarray(a, np.float32), np.float32)
        b = (b.float().numpy() if isinstance(b, torch.Tensor)
             else np.asarray(b, np.float32))
        assert a.shape == b.shape, name
        tol = BF16_DX_TOL if name == "dx" and xdtype == torch.bfloat16 \
            else F32_TOL
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, f"{name}: {err:.3e} of max {scale:.3e}"


# (B, S, di, N, xdtype, extra keywords of scan_inputs)
REF_CASES = {
    "N16 ragged S=100": (2, 100, 24, 16, torch.float32, {}),
    "N8 S=64": (2, 64, 16, 8, torch.float32, {}),
    "S=1": (1, 1, 16, 16, torch.float32, {}),
    "dh_final None": (2, 70, 16, 16, torch.float32, {"dh_final": False}),
    "zero h0": (1, 40, 16, 8, torch.float32, {"h0_scale": 0.0}),
    "xr bf16": (2, 50, 16, 16, torch.bfloat16, {}),
    "B, C views of a projection": (2, 45, 16, 16, torch.float32,
                                   {"rank": 5}),
    "long memory S=300": (1, 300, 16, 16, torch.bfloat16,
                          {"long_memory": True, "h0_scale": 1.0,
                           "rank": 3}),
    "long memory N8 ragged S=130": (2, 130, 24, 8, torch.float32,
                                    {"long_memory": True}),
}


@pytest.mark.parametrize("case", list(REF_CASES))
def test_plain_backward_matches_jax_vjp_and_autograd(case):
    B, S, di, N, xdtype, kw = REF_CASES[case]
    d = scan_inputs(41, B, S, di, N, **kw)
    dhf = None if d["dhf"] is None else torch.from_numpy(d["dhf"])
    got = ssm_scan_ref_bwd(*torch_args(d, xdtype), torch.from_numpy(d["dy"]),
                           dhf)
    assert got[1].dtype == xdtype
    assert_grads(got, jax_grads(d, xdtype), xdtype)
    assert_grads(got, torch_autograd_grads(d, xdtype), xdtype)


def test_plain_backward_of_an_empty_sequence():
    """S = 0: every gradient but dh0 is zero (or empty); dh0 is
    dh_final, the state having passed through no step."""
    d = scan_inputs(42, 2, 0, 16, 16)
    got = ssm_scan_ref_bwd(*torch_args(d), torch.from_numpy(d["dy"]),
                           torch.from_numpy(d["dhf"]))
    assert [tuple(g.shape) for g in got] == [(2, 0, 16), (2, 0, 16),
                                             (2, 0, 16), (2, 0, 16),
                                             (16, 16), (2, 16, 16)]
    assert not got[4].any()
    assert torch.equal(got[5], torch.from_numpy(d["dhf"]))


# ------------------------------------------------------ the kernel's design

def bwd_shape(N, R):
    """(G, CH, W, L): lanes a channel, channels a block, channels a warp,
    steps a sub-chunk."""
    G = N // R
    return G, THREADS // G, 32 // G, 32 // R


def cluster_size(nblk):
    """The blocks of a cluster: the largest power of two up to
    ``MAX_CLUSTER`` and up to the blocks of a batch row."""
    cl = 1
    while cl * 2 <= min(MAX_CLUSTER, nblk):
        cl *= 2
    return cl


def lanes_sum(x):
    """x[..., G] summed as the reduce-scatter over a channel's G lanes adds
    them: lanes paired from the top bit down, each half onto the other."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def warp_sum(x, dim):
    """x summed over ``dim`` (a warp's W channels) as the reduce-scatter
    from the top bit down pairs them: each half onto the other."""
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def in_order(x, dim):
    """x summed over ``dim`` one entry after another, from zero."""
    s = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        s = s + x.select(dim, i)
    return s


def design_scan_bwd(dt, xr, Bm, Cm, A, h0, dy, dh_final=None, *, R):
    """The backward kernel's arithmetic at R states a thread on states
    saved every ``CHUNK`` steps, in f32: (d(dt), dx in xr's dtype, dB, dC,
    dA, dh0). Intervals of ``CHUNK`` steps from the last, each in
    sub-chunks of L = 32 / R steps from the last (the states entering the
    later ones from a pass over the interval's first steps), each
    recomputed once for its decays and the state entering each group of G
    steps, then walked back group by group on states rebuilt from those;
    the sums in the kernel's order."""
    xdtype = xr.dtype
    dt, xr, Bm, Cm, A, h0, dy = (t.float() for t in
                                 (dt, xr, Bm, Cm, A, h0, dy))
    B, S, di = dt.shape
    N = A.shape[1]
    G, CH, W, L = bwd_shape(N, R)
    nc = -(-S // CHUNK)
    nblk = -(-di // CH)
    cl = cluster_size(nblk)
    ncl = -(-nblk // cl)
    # the masked tail of S, and of di up to whole clusters of blocks
    ps, pd = nc * CHUNK - S, ncl * cl * CH - di
    dt, xr, dy = (F.pad(t, (0, pd, 0, ps)) for t in (dt, xr, dy))
    Bm, Cm = (F.pad(t, (0, 0, 0, ps)) for t in (Bm, Cm))
    A, h0 = F.pad(A, (0, 0, 0, pd)), F.pad(h0, (0, 0, 0, pd))
    dp = di + pd
    A2 = A * LOG2E

    def decay(t):
        return torch.exp2(dt[:, t, :, None] * A2)

    def step(h, a, t):                            # the forward's operations
        return h * a + (dt[:, t] * xr[:, t])[..., None] * Bm[:, t, None, :]

    hs, h = [], h0                                # the forward's saved states
    for t in range(nc * CHUNK):
        if t % CHUNK == 0:
            hs.append(h)
        h = step(h, decay(t), t)
    carry = (torch.zeros_like(h0) if dh_final is None
             else F.pad(dh_final.float(), (0, 0, 0, pd)))
    dA = torch.zeros_like(h0)                     # per thread: (b, d, n)
    ddt, dx = torch.zeros_like(dt), torch.zeros_like(dt)
    ws = torch.zeros((B, ncl, nc * CHUNK, 2 * N))  # one row per cluster
    for c in range(nc - 1, -1, -1):
        t0 = c * CHUNK
        starts, h = [hs[c]], hs[c]                # entering each sub-chunk
        for t in range(t0, t0 + CHUNK - L):
            h = step(h, decay(t), t)
            if (t - t0) % L == L - 1:
                starts.append(h)
        for sub in range(CHUNK // L - 1, -1, -1):
            s0 = t0 + sub * L
            decays, entering, h = [], [], starts[sub]   # the recompute
            for i in range(L):
                if i % G == 0:
                    entering.append(h)
                decays.append(decay(s0 + i))
                h = step(h, decays[-1], s0 + i)
            for grp in range(L // G - 1, -1, -1):
                states = [entering[grp]]          # h_{t-1}, then each h_t
                for i in range(grp * G, grp * G + G):
                    states.append(step(states[-1], decays[i], s0 + i))
                sa, sx = [None] * G, [None] * G
                for s in range(G - 1, -1, -1):
                    i = grp * G + s
                    t = s0 + i
                    g = dy[:, t, :, None] * Cm[:, t, None, :] + carry
                    pg = g * (decays[i] * states[s])
                    dA = dA + pg * dt[:, t, :, None]
                    sa[s] = in_order((pg * A).view(B, dp, G, R), 3)
                    sx[s] = in_order((g * Bm[:, t, None, :]).view(
                        B, dp, G, R), 3)
                    carry = decays[i] * g
                    for off, v in ((0, g * (dt[:, t] * xr[:, t])[..., None]),
                                   (N, dy[:, t, :, None] * states[s + 1])):
                        # the warp's channels, the block's warps in order,
                        # then the cluster's blocks in rank order
                        v = warp_sum(v.view(B, ncl, cl, WARPS, W, N), 4)
                        ws[:, :, t, off:off + N] = in_order(in_order(v, 3), 2)
                for s in range(G):                # the group's lane sums
                    t = s0 + grp * G + s
                    SA, SX = lanes_sum(sa[s]), lanes_sum(sx[s])
                    ddt[:, t] = SA + xr[:, t] * SX
                    dx[:, t] = dt[:, t] * SX
    dBC = in_order(ws, 1)[:, :S]                  # the clusters in order
    return (ddt[:, :S, :di], dx[:, :S, :di].to(xdtype), dBC[..., :N],
            dBC[..., N:], in_order(dA, 0)[:di], carry[:, :di])


# (B, S, di, N, R, xdtype, extra keywords of scan_inputs)
DESIGN_CASES = {
    "N16 R4 ragged S=70 di=40": (1, 70, 40, 16, 4, torch.float32, {}),
    "N16 R2 B=2 S=64": (2, 64, 32, 16, 2, torch.float32, {}),
    "N8 R2 ragged di=50": (2, 45, 50, 8, 2, torch.float32, {}),
    "N8 R4 S=96": (1, 96, 64, 8, 4, torch.float32, {}),
    "S=1 R4": (1, 1, 32, 16, 4, torch.float32, {}),
    "xr bf16 R2 views": (2, 40, 16, 16, 2, torch.bfloat16, {"rank": 3}),
    "dh_final None R4": (1, 50, 32, 16, 4, torch.float32,
                         {"dh_final": False}),
    "long memory R4 S=200": (1, 200, 32, 16, 4, torch.bfloat16,
                             {"long_memory": True, "h0_scale": 1.0}),
    "R2 di=176: 11 blocks, clusters of 8, 5 masked": (
        1, 40, 176, 16, 2, torch.float32, {"long_memory": True}),
    "R4 di=80: 3 blocks, clusters of 2, 1 masked": (
        2, 50, 80, 16, 4, torch.bfloat16, {"h0_scale": 1.0}),
    "R2 ragged S=70 di=48 views": (
        1, 70, 48, 16, 2, torch.float32, {"rank": 2}),
    "R4 long memory S=100 bf16: two sub-chunks an interval": (
        1, 100, 64, 16, 4, torch.bfloat16,
        {"long_memory": True, "h0_scale": 1.0}),
    "N8 R4 ragged S=37 di=136": (2, 37, 136, 8, 4, torch.float32, {}),
}


@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_design_scan_bwd_matches_jax_vjp(case):
    B, S, di, N, R, xdtype, kw = DESIGN_CASES[case]
    d = scan_inputs(43, B, S, di, N, **kw)
    dhf = None if d["dhf"] is None else torch.from_numpy(d["dhf"])
    args = (*torch_args(d, xdtype), torch.from_numpy(d["dy"]), dhf)
    got = design_scan_bwd(*args, R=R)
    assert got[1].dtype == xdtype
    assert_grads(got, jax_grads(d, xdtype), xdtype)
    assert_grads(got, ssm_scan_ref_bwd(*args), xdtype)
    again = design_scan_bwd(*args, R=R)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_design_masked_steps_add_nothing():
    """Masked steps pass g through and add nothing: the design on S = 40
    steps (masked to 64) against the same inputs padded by hand to 100
    steps with dt = x = dy = B = C = 0 (two more chunks, all masked), cut
    back: equal bit for bit."""
    d = scan_inputs(44, 1, 40, 32, 16, long_memory=True)
    dt, xr, Bm, Cm, A, h0 = torch_args(d)
    dy, dhf = torch.from_numpy(d["dy"]), torch.from_numpy(d["dhf"])
    got = design_scan_bwd(dt, xr, Bm, Cm, A, h0, dy, dhf, R=4)
    pad = (lambda t: F.pad(t, (0, 0, 0, 60)))
    padded = design_scan_bwd(pad(dt), pad(xr), pad(Bm.contiguous()),
                             pad(Cm.contiguous()), A, h0, pad(dy), dhf, R=4)
    for a, b in zip(got, padded):
        b = b[:, :40] if b.dim() == 3 and b.shape[1] == 100 else b
        assert torch.equal(a, b)


# --------------------------------------------------- the autograd Function

def _leaves(d, xdtype=torch.float32):
    """dt, xr, proj, A, h0 as leaves that require grad, and the scan's
    inputs made from them (B and C views of proj)."""
    r, N = d["rank"], d["N"]
    leaves = [torch.from_numpy(d[k]).requires_grad_(True)
              for k in ("dt", "xr", "proj", "A", "h0")]
    if xdtype != torch.float32:
        leaves[1] = leaves[1].detach().to(xdtype).requires_grad_(True)
    dt, xr, proj, A, h0 = leaves
    return leaves, (dt, xr, proj[..., r:r + N], proj[..., r + N:], A, h0)


def test_function_runs_on_cpu_tensors_and_drops_a_none_dh_final():
    """With grad, `selective_scan` is the Function: the forward is
    `ssm_scan_ref`'s bit for bit, h_final unused reaches the backward as
    None, and the gradients are `ssm_scan_ref_bwd`'s with dh_final None,
    B and C's landing in their columns of the projection."""
    d = scan_inputs(45, 2, 37, 24, 16, rank=4)
    leaves, args = _leaves(d)
    y, h = selective_scan(*args)
    assert y.grad_fn is not None and "SelectiveScan" in type(
        y.grad_fn).__name__
    y_ref, h_ref = ssm_scan_ref(*(t.detach() for t in args))
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    dy = torch.from_numpy(d["dy"])
    grads = torch.autograd.grad(y, leaves, dy)
    want = ssm_scan_ref_bwd(*(t.detach() for t in args), dy, None)
    dproj = torch.zeros_like(grads[2])
    dproj[..., 4:20], dproj[..., 20:] = want[2], want[3]
    for a, b in zip(grads, (want[0], want[1], dproj, want[4], want[5])):
        assert torch.equal(a, b)


def test_function_backward_answers_only_what_is_needed():
    """The backward returns None for each input ``needs_input_grad`` does
    not ask for, and the plain backward's gradient for the others."""
    d = scan_inputs(46, 1, 20, 16, 8)
    args = torch_args(d)
    dy = torch.from_numpy(d["dy"])

    class Ctx:
        saved_tensors = args
        needs_input_grad = (True, False, False, True, True, False)

    out = scan_ops._SelectiveScan.backward(Ctx, dy, None)
    want = ssm_scan_ref_bwd(*args, dy, None)
    for need, a, b in zip(Ctx.needs_input_grad, out, want):
        assert (a is None) if not need else torch.equal(a, b)
    # autograd asks for dt alone
    leaves, targs = _leaves(d)
    targs = (targs[0],) + tuple(t.detach() for t in targs[1:])
    y, _ = selective_scan(*targs)
    (g,) = torch.autograd.grad(y, targs[0], dy)
    assert torch.equal(g, want[0])


def test_function_gives_dx_in_xr_dtype():
    d = scan_inputs(47, 2, 33, 16, 16, h0_scale=1.0)
    leaves, args = _leaves(d, torch.bfloat16)
    y, h = selective_scan(*args)
    dhf = torch.from_numpy(d["dhf"])
    grads = torch.autograd.grad((y, h), leaves,
                                (torch.from_numpy(d["dy"]), dhf))
    assert grads[1].dtype == torch.bfloat16
    assert_grads((grads[0], grads[1], grads[2][..., :16], grads[2][..., 16:],
                  grads[3], grads[4]), jax_grads(d, torch.bfloat16),
                 torch.bfloat16)


def test_kernel_entry_points_raise_on_cpu_tensors():
    """The backward and the state-saving forward are kernels only: CPU
    tensors raise before anything is built, and nothing is counted; R is
    not forced under autograd."""
    d = scan_inputs(48, 1, 40, 16, 16)
    args = torch_args(d)
    hs = torch.zeros((1, 2, 16, 16))
    counts = (scan_ops.launches, scan_ops.bwd_launches)
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_bwd(*args[:5], hs, torch.from_numpy(d["dy"]))
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan_states(*args)
    leaves, targs = _leaves(d)
    with pytest.raises(ValueError, match="autograd"):
        scan_ops.selective_scan_at(*targs, R=4)
    assert (scan_ops.launches, scan_ops.bwd_launches) == counts
