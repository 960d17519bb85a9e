"""The port's selective scan and Mamba block against the JAX package.

The same numpy inputs (from a seed) go through both packages:

* the scan's plain version `ssm_scan_ref` and its wrapper `selective_scan`
  on CPU tensors against the Pallas `ssm_scan` in interpret mode and
  against the reference oracle, at the shapes of
  tests/test_kernels.py::TestSsmScan, f32, atol = rtol = 1e-4 as there;
* the model path's plain scan `ssm_scan_chunked` against the reference's;
* `_causal_conv`, `mamba_layer` and `mamba_decode_step` against the
  reference's on the same params: in f32 to 1e-4 (only the order of the
  sums differs), in bf16 to 2e-2 (the kernels' bf16 tolerance: XLA and
  PyTorch round bf16 intermediates at different places).

The CUDA kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.kernels.ssm_scan import ssm_scan as ref_ssm_scan
from repro.kernels.ssm_scan import ssm_scan_ref as ref_ssm_scan_ref
from repro.models import mamba as RM
from repro_torch.configs import registry
from repro_torch.kernels.ssm_scan import selective_scan, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.models import mamba as M
from repro_torch.models.convert import params_from_numpy

SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ARCH = "falcon-mamba-7b"


def scan_inputs(seed, B, S, di, N, h0_scale=0.1):
    """dt, xr, B, C, A, h0 as numpy f32, drawn as TestSsmScan draws them."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))) * 0.1
    xr = rng.standard_normal((B, S, di))
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    A = -np.exp(rng.standard_normal((di, N)) * 0.5)
    h0 = rng.standard_normal((B, di, N)) * h0_scale
    return [a.astype(np.float32) for a in (dt, xr, Bm, Cm, A, h0)]


def _close(out, ref, atol, rtol=None):
    np.testing.assert_allclose(
        out.float().numpy() if isinstance(out, torch.Tensor) else out,
        np.asarray(ref, np.float32), atol=atol,
        rtol=atol if rtol is None else rtol)


SCAN_SHAPES = [                                   # TestSsmScan's shapes
    (2, 256, 128, 16, 64, 64),
    (1, 100, 256, 16, 128, 128),                  # ragged seq
    (2, 128, 64, 8, 32, 64),
    (1, 64, 128, 16, 64, 32),                     # narrow channel blocks
]


@pytest.mark.parametrize("B,S,di,N,chunk,bd", SCAN_SHAPES)
def test_scan_matches_pallas_kernel_and_oracle(B, S, di, N, chunk, bd):
    arrs = scan_inputs(5, B, S, di, N)
    jy, jh = ref_ssm_scan(*map(jnp.asarray, arrs), chunk=chunk, block_d=bd,
                          interpret=True)
    oy, oh = ref_ssm_scan_ref(*map(jnp.asarray, arrs))
    tens = [torch.from_numpy(a) for a in arrs]
    before = scan_ops.launches
    for fn in (ssm_scan_ref, selective_scan):
        y, h = fn(*tens)
        assert y.dtype == h.dtype == torch.float32
        for ref_y, ref_h in ((jy, jh), (oy, oh)):
            _close(y, ref_y, **SCAN_TOL)
            _close(h, ref_h, **SCAN_TOL)
    assert scan_ops.launches == before          # no kernel on the CPU


def test_scan_state_continuation():
    """Scanning [0:S] equals scanning [0:S/2] then [S/2:S] with the
    carried state, in both packages."""
    B, S, di, N = 1, 128, 64, 8
    dt, xr, Bm, Cm, A, _ = scan_inputs(6, B, S, di, N)
    h0 = np.zeros((B, di, N), np.float32)
    t = [torch.from_numpy(a) for a in (dt, xr, Bm, Cm, A, h0)]
    y_full, h_full = selective_scan(*t)
    half = S // 2
    y1, h1 = selective_scan(*(x[:, :half] for x in t[:4]), t[4], t[5])
    y2, h2 = selective_scan(*(x[:, half:] for x in t[:4]), t[4], h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full,
                               **SCAN_TOL)
    torch.testing.assert_close(h2, h_full, **SCAN_TOL)
    jy, jh = ref_ssm_scan(*map(jnp.asarray, (dt, xr, Bm, Cm, A, h0)),
                          chunk=32, block_d=64)
    _close(y_full, jy, **SCAN_TOL)
    _close(h2, jh, **SCAN_TOL)


def test_scan_takes_bf16_x_and_strided_b_c():
    """The model path's inputs: xr in bf16, B and C column slices of one
    (B, S, R + 2N) projection."""
    B, S, di, N, R = 2, 40, 64, 16, 8
    dt, xr, _, _, A, h0 = scan_inputs(7, B, S, di, N)
    proj = np.random.default_rng(8).standard_normal(
        (B, S, R + 2 * N)).astype(np.float32)
    tp = torch.from_numpy(proj)
    Bm, Cm = tp[..., R:R + N], tp[..., R + N:]
    assert Bm.stride(1) == R + 2 * N
    xb = torch.from_numpy(xr).to(torch.bfloat16)
    y, h = selective_scan(torch.from_numpy(dt), xb, Bm, Cm,
                          torch.from_numpy(A), torch.from_numpy(h0))
    jy, jh = ref_ssm_scan_ref(jnp.asarray(dt), jnp.asarray(xb.float().numpy()),
                              jnp.asarray(proj[..., R:R + N]),
                              jnp.asarray(proj[..., R + N:]), jnp.asarray(A),
                              jnp.asarray(h0))
    _close(y, jy, **SCAN_TOL)
    _close(h, jh, **SCAN_TOL)


@pytest.mark.parametrize("bad, match", [
    ({"dt": torch.float64}, "float32"),
    ({"Bmat": (2, 9, 16)}, "Bmat has shape"),
    ({"A": (64, 5)}, "shape"),
])
def test_scan_rejects_bad_arguments(bad, match):
    names = ("dt", "xr", "Bmat", "Cmat", "A", "h0")
    t = dict(zip(names, map(torch.from_numpy, scan_inputs(9, 2, 8, 64, 16))))
    for name, what in bad.items():
        t[name] = (t[name].to(what) if isinstance(what, torch.dtype)
                   else torch.zeros(what))
    with pytest.raises((TypeError, ValueError), match=match):
        selective_scan(*(t[n] for n in names))


@pytest.mark.parametrize("B,S,di,N,chunk", [
    (2, 256, 64, 16, 128),
    (1, 300, 32, 16, 128),                        # ragged: 2 chunks + 44
    (2, 77, 48, 8, 32),
])
def test_chunked_scan_matches_reference(B, S, di, N, chunk):
    arrs = scan_inputs(10, B, S, di, N, h0_scale=0.5)
    jy, jh = RM.ssm_scan_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    y, h = M.ssm_scan_chunked(*map(torch.from_numpy, arrs), chunk=chunk)
    _close(y, jy, **SCAN_TOL)
    _close(h, jh, **SCAN_TOL)


# ----------------------------------------------------------- the Mamba block

@pytest.fixture(scope="module", params=list(DTYPES))
def block(request):
    """The reference's Mamba params at smoke width in one dtype, and the
    port's copy of them."""
    jd, td, tol = DTYPES[request.param]
    cfg = ref_registry.get_smoke(ARCH)
    rp = RM.init_mamba(jax.random.PRNGKey(3), cfg, jd)
    return cfg, rp, params_from_numpy(jax.tree.map(np.asarray, rp)), jd, td, tol


def _x(seed, shape, jd, td, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def test_causal_conv_matches_reference(block):
    cfg, rp, pp, jd, td, tol = block
    jx, tx = _x(11, (2, 24, cfg.d_inner), jd, td)
    js, ts = _x(12, (2, cfg.ssm_conv - 1, cfg.d_inner), jd, td)
    for jstate, tstate in ((None, None), (js, ts)):
        jy, jnew = RM._causal_conv(jx, rp["conv_w"], rp["conv_b"], jstate)
        y, new = M._causal_conv(tx, pp["conv_w"], pp["conv_b"], tstate)
        assert y.dtype == td
        _close(y, jy, tol)
        torch.testing.assert_close(new, tx[:, -(cfg.ssm_conv - 1):])


@pytest.mark.parametrize("plain", [False, True])
def test_mamba_layer_matches_reference(block, plain):
    cfg, rp, pp, jd, td, tol = block
    jx, tx = _x(13, (2, 40, cfg.d_model), jd, td)
    jh, th = _x(14, (2, cfg.d_inner, cfg.ssm_state), jnp.float32,
                torch.float32, 0.1)
    js, ts = _x(15, (2, cfg.ssm_conv - 1, cfg.d_inner), jnp.bfloat16,
                torch.bfloat16)
    for jstate, tstate in ((None, None), ({"conv": js, "ssm": jh},
                                          {"conv": ts, "ssm": th})):
        jy, jst = RM.mamba_layer(rp, cfg, jx, jstate)
        y, st = M.mamba_layer(pp, cfg, tx, tstate, plain=plain)
        assert y.dtype == td and st["conv"].dtype == torch.bfloat16
        assert st["ssm"].dtype == torch.float32
        _close(y, jy, tol)
        _close(st["conv"], jst["conv"], 2e-2)
        _close(st["ssm"], jst["ssm"], tol)


def test_mamba_decode_step_matches_reference(block):
    cfg, rp, pp, jd, td, tol = block
    jh, th = _x(16, (2, cfg.d_inner, cfg.ssm_state), jnp.float32,
                torch.float32, 0.1)
    js, ts = _x(17, (2, cfg.ssm_conv - 1, cfg.d_inner), jnp.bfloat16,
                torch.bfloat16)
    jstate, state = {"conv": js, "ssm": jh}, {"conv": ts, "ssm": th}
    for step in range(3):
        jx, tx = _x(18 + step, (2, 1, cfg.d_model), jd, td)
        jy, jstate = RM.mamba_decode_step(rp, cfg, jx, jstate)
        y, state = M.mamba_decode_step(pp, cfg, tx, state)
        assert y.shape == (2, 1, cfg.d_model) and y.dtype == td
        assert state["conv"].dtype == torch.bfloat16
        _close(y, jy, tol)
        _close(state["conv"], jstate["conv"], 2e-2)
        _close(state["ssm"], jstate["ssm"], tol)


def test_decode_steps_continue_the_layer(block):
    """The layer over S tokens then one decode step equals the layer over
    S + 1 tokens: the conv tail and the SSM state carry over. The conv
    tail is kept in bf16 (as in the reference) even for f32 params, so
    the bf16 tolerance holds for both dtypes."""
    cfg, _, pp, jd, td, _ = block
    _, tx = _x(21, (1, 17, cfg.d_model), jd, td)
    y_all, st_all = M.mamba_layer(pp, cfg, tx)
    _, st = M.mamba_layer(pp, cfg, tx[:, :-1])
    y_step, st_step = M.mamba_decode_step(pp, cfg, tx[:, -1:], st)
    _close(y_step[:, 0], y_all[:, -1].float().numpy(), 2e-2)
    _close(st_step["ssm"], st_all["ssm"].numpy(), 2e-2)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_deterministic_init_leaves_equal_reference(arch):
    """D_skip, dt_bias and conv_b equal the reference's bit for bit. A_log
    is log(1..N) correctly rounded to f32, the same on every machine; the
    reference takes XLA's f32 log, which may be one ulp off (its log(7)
    is), so A_log is held to one ulp."""
    cfg = registry.get_smoke(arch)
    ref = RM.init_mamba(jax.random.PRNGKey(0), ref_registry.get_smoke(arch),
                        jnp.bfloat16)
    port = M.init_mamba(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert list(port) == list(ref)
    for name in ("A_log", "D_skip", "dt_bias", "conv_b"):
        want = params_from_numpy(np.asarray(ref[name]))
        assert port[name].dtype == want.dtype, name
        if name == "A_log":
            np.testing.assert_array_max_ulp(port[name].numpy(),
                                            want.numpy(), maxulp=1)
            np.testing.assert_array_equal(
                port[name][0].numpy(),
                np.log(np.arange(1, cfg.ssm_state + 1, dtype=np.float64)
                       ).astype(np.float32))
        else:
            assert torch.equal(port[name], want), name
    for name in ("in_proj", "conv_w", "x_proj", "dt_proj", "out_proj"):
        assert port[name].shape == ref[name].shape, name
        assert port[name].dtype == torch.bfloat16, name
