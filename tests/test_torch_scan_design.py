"""The arithmetic of the CUDA selective-scan kernel, on the CPU.

``src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu`` gives each thread
one channel and R of its N states. Each step it forms dt * x once, takes
each decay as exp2(dt * (A log2 e)) with A scaled once, runs h = h * da +
(dt x) B_t for its R states and sums its R terms of y in order; the
G = N / R lanes of a channel then reduce-scatter their partial sums over
G steps at once, so lane k ends with y of step g + k. The ragged tail of S
(to whole chunks of T steps) and of di (to whole blocks of CH channels)
is masked with zeros: a masked step has dt = 0, so its decay is exactly 1.
`design_scan` repeats that arithmetic in plain PyTorch, in f32, and is
held against the Pallas kernel in interpret mode and against the port's
plain version at the kernel's tolerance (atol = rtol = 1e-4), on inputs
made from fixed numpy seeds, including the model's long-memory inputs
(dt = softplus(z - 4.6) ~ 0.01, A = -(1..N), as `init_mamba` sets them).

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan
from repro_torch.kernels.ssm_scan import ssm_scan_ref

THREADS, STAGE = 128, 1024          # threads a block, (step, channel) pairs a chunk
LOG2E = 1.4426950408889634
TOL = dict(atol=1e-4, rtol=1e-4)


def kernel_shape(N, R):
    """(G, CH, T): lanes a channel, channels a block, steps a chunk."""
    G = N // R
    CH = THREADS // G
    return G, CH, STAGE // CH


def reduce_scatter(p):
    """p[..., lane, step] (G lanes, G steps) -> y[..., k]: the butterfly
    of the kernel, after which lane k holds the sum over the lanes of
    step k."""
    G = p.shape[-1]
    lanes = torch.arange(G)
    w = G // 2
    while w >= 1:
        upper = (lanes & w) != 0
        q = p[..., lanes ^ w, :]                  # the partner's values
        nxt = p.clone()
        for j in range(w):
            keep = torch.where(upper, p[..., j + w], p[..., j])
            recv = torch.where(upper, q[..., j + w], q[..., j])
            nxt[..., j] = keep + recv
        p = nxt
        w //= 2
    return p[..., 0]


def design_scan(dt, xr, Bm, Cm, A, h0, *, R):
    """dt, xr: (B, S, di); Bm, Cm: (B, S, N); A: (di, N); h0: (B, di, N).
    The kernel's arithmetic at R states per thread, in f32. Returns
    (y, h_final)."""
    dt, xr, Bm, Cm, A, h0 = (t.float() for t in (dt, xr, Bm, Cm, A, h0))
    B, S, di = dt.shape
    N = A.shape[1]
    G, CH, T = kernel_shape(N, R)
    ps, pd = -S % T, -di % CH                     # the masked tail
    dt, xr = (F.pad(t, (0, pd, 0, ps)) for t in (dt, xr))
    Bm, Cm = (F.pad(t, (0, 0, 0, ps)) for t in (Bm, Cm))
    A2 = F.pad(A * LOG2E, (0, 0, 0, pd)).view(-1, G, R)   # scaled once
    h = F.pad(h0, (0, 0, 0, pd)).view(B, -1, G, R)
    dtx = dt * xr
    ys = []
    for g in range(0, S + ps, G):
        p = torch.zeros(*h.shape[:3], G)          # (B, di, lane, step)
        for s in range(G):
            t = g + s
            da = torch.exp2(dt[:, t, :, None, None] * A2)
            h = h * da + dtx[:, t, :, None, None] * Bm[:, t].view(B, 1, G, R)
            hc = h * Cm[:, t].view(B, 1, G, R)
            acc = torch.zeros(h.shape[:3])
            for j in range(R):                    # in order, as the fma chain
                acc = acc + hc[..., j]
            p[..., s] = acc
        ys.append(reduce_scatter(p))              # (B, di, G): step g + k
    y = (torch.cat(ys, dim=-1).transpose(1, 2) if ys
         else dt.new_zeros((B, 0, di + pd)))
    return y[:, :S, :di].contiguous(), h.reshape(B, -1, N)[:, :di]


def scan_inputs(seed, B, S, di, N, *, h0_scale=0.1, long_memory=False):
    """dt, xr, B, C, A, h0 as numpy f32: as TestSsmScan draws them, or as
    the model makes them (dt = softplus(z - 4.6), A = -(1..N))."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, S, di))
    if long_memory:
        dt = np.logaddexp(z - 4.6, 0.0)
        A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float64), (di, N))
    else:
        dt = np.logaddexp(z, 0.0) * 0.1
        A = -np.exp(rng.standard_normal((di, N)) * 0.5)
    xr = rng.standard_normal((B, S, di))
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, di, N)) * h0_scale
    return [np.ascontiguousarray(a, np.float32)
            for a in (dt, xr, Bm, Cm, A, h0)]


# (B, S, di, N, R, long_memory, h0_scale)
CASES = {
    "N16 R2": (1, 192, 64, 16, 2, False, 0.1),
    "N16 R4": (1, 192, 64, 16, 4, False, 0.1),
    "N16 R8": (1, 192, 64, 16, 8, False, 0.1),
    "N16 R16": (1, 192, 64, 16, 16, False, 0.1),
    "N8 R2": (1, 160, 64, 8, 2, False, 0.1),
    "N8 R4": (1, 160, 64, 8, 4, False, 0.1),
    "N8 R8": (1, 160, 64, 8, 8, False, 0.1),
    "ragged S=100 di=40 R2": (1, 100, 40, 16, 2, False, 0.1),
    "ragged S=37 R8": (1, 37, 64, 16, 8, False, 0.5),
    "S=1 R4": (1, 1, 32, 16, 4, False, 0.5),
    "S=0 R4": (1, 0, 32, 16, 4, False, 0.5),
    "B=2 nonzero h0 R4": (2, 192, 32, 16, 4, False, 1.0),
    "B=2 nonzero h0 N8 R2": (2, 96, 32, 8, 2, False, 1.0),
    "long memory N16 R4 S=2048": (1, 2048, 32, 16, 4, True, 1.0),
    "long memory N16 R2 ragged S=500": (1, 500, 48, 16, 2, True, 1.0),
    "long memory N8 R4 B=2": (2, 300, 32, 8, 4, True, 1.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_design_scan_matches_pallas_kernel_and_plain_version(case):
    B, S, di, N, R, long_memory, h0_scale = CASES[case]
    arrs = scan_inputs(31, B, S, di, N, h0_scale=h0_scale,
                       long_memory=long_memory)
    y, h = design_scan(*map(torch.from_numpy, arrs), R=R)
    assert y.shape == (B, S, di) and h.shape == (B, di, N)
    ry, rh = ssm_scan_ref(*map(torch.from_numpy, arrs))
    refs = [(ry.numpy(), rh.numpy())]
    if S:                                  # the Pallas kernel needs a chunk
        jy, jh = pallas_ssm_scan(*map(jnp.asarray, arrs), chunk=min(128, S),
                                 block_d=min(128, di), interpret=True)
        refs.append((np.asarray(jy), np.asarray(jh)))
    for ref_y, ref_h in refs:
        np.testing.assert_allclose(y.numpy(), ref_y, **TOL)
        np.testing.assert_allclose(h.numpy(), ref_h, **TOL)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_reduce_scatter_leaves_step_k_on_lane_k(G):
    p = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (3, 5, G, G)).astype(np.float32))
    np.testing.assert_allclose(reduce_scatter(p).numpy(),
                               p.sum(dim=-2).numpy(), rtol=1e-6, atol=1e-6)


def test_masked_steps_pass_the_state_through_exactly():
    """The steps that pad S to whole chunks leave the state bit for bit
    as it was after step S: the same recurrence run over the S steps
    alone, in the same f32 operations, gives the same h_final."""
    B, S, di, N, R = 1, 50, 40, 16, 2
    assert S % kernel_shape(N, R)[2]       # the tail is masked
    tens = list(map(torch.from_numpy, scan_inputs(
        33, B, S, di, N, h0_scale=1.0, long_memory=True)))
    dt, xr, Bm, _, A, h = tens
    A2 = A * LOG2E
    for t in range(S):
        h = (h * torch.exp2(dt[:, t, :, None] * A2)
             + (dt[:, t] * xr[:, t])[..., None] * Bm[:, t, None, :])
    _, h_kernel = design_scan(*tens, R=R)
    assert torch.equal(h_kernel, h)
