"""The arithmetic of the prefill kernel's two bodies, modelled on the CPU.

``csrc/flash_attention.cu`` picks its body from the dtype and head dim
(`ops.body`). The tensor-core body works on 128 x 128 tiles: scores
S = Q K^T in f32, scaled by log2(e) / sqrt(hd) after the product and
masked with -1e30, an online softmax with exp2, and P rounded to bf16
before P V, which the Pallas kernel computes in f32. The SIMT body works
on 64 x 64 tiles with Q scaled before the product and P in f32.
`tiled_prefill` below repeats either body's arithmetic in plain PyTorch,
tile by tile and CTA by CTA with the kernel's tile skipping, so the CPU
can answer whether bf16 P keeps the prefill within the bf16 tolerance.
It is held against the Pallas kernel in interpret mode and against the
port's plain version.

The wrapper's TMA checks (which tensors the tensor-core body can
describe) are plain Python and are tested here too; the kernel itself
runs only on a card (tests/test_torch_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention
from repro_torch.kernels import _launch as X
from repro_torch.kernels.flash_attention import attention_ref, mha_ref
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30
LOG2E = 1.4426950408889634
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
#: body -> (query rows per CTA, key rows per tile)
TILES = {"wgmma": (128, 128), "simt": (64, 64)}


def tiled_prefill(q, k, v, *, causal, window, body):
    """q: (B, H, Sq, hd); k, v: (B, K, Sk, hd) -> (B, H, Sq, hd) in
    q.dtype, with the named body's tiles, scaling, exponent and P type."""
    B, H, Sq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    bm, bn = TILES[body]
    pad = (-Sk) % bn                    # rows TMA zero-fills past the end
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    kf, vf = kf.repeat_interleave(G, dim=1), vf.repeat_interleave(G, dim=1)
    if body == "wgmma":
        qf = q.float()
        scale = torch.tensor(LOG2E, dtype=torch.float32) / math.sqrt(hd)
        exp = torch.exp2
    else:
        qf = q.float() * (1.0 / math.sqrt(hd))
        scale = None
        exp = torch.exp
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32)
    for q0 in range(0, Sq, bm):
        rows = torch.arange(q0, min(q0 + bm, Sq))
        k_lo, k_hi = 0, Sk
        if causal:
            k_hi = min(Sk, q0 + bm)
        if window > 0:
            k_lo = max(0, q0 - window + 1)
        first = (k_lo // bn) * bn
        m = torch.full((B, H, len(rows)), NEG_INF)
        l = torch.zeros((B, H, len(rows)))
        o = torch.zeros((B, H, len(rows), hd))
        for k0 in range(first, k_hi, bn):
            s = qf[:, :, rows] @ kf[:, :, k0:k0 + bn].transpose(-1, -2)
            if scale is not None:
                s = s * scale
            kp = torch.arange(k0, k0 + bn)[None, :]
            ok = kp < Sk
            if causal:
                ok = ok & (kp <= rows[:, None])
            if window > 0:
                ok = ok & ((rows[:, None] - kp) < window)
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = exp(m - m_new)
            p = exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            if body == "wgmma":
                p = p.to(torch.bfloat16).float()
            o = o * alpha[..., None] + p @ vf[:, :, k0:k0 + bn]
            m = m_new
        out[:, :, rows] = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _inputs(B, H, K, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    jd, td, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in [(B, H, S, hd), (B, K, S, hd), (B, K, S, hd)]]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(ref, out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# (B, H, K, S, hd, causal, window)
CASES = {
    "ragged S200 hd64": (1, 4, 2, 200, 64, True, 0),
    "window mid-tile S300 w96 hd128": (1, 4, 2, 300, 128, True, 96),
    "hymba H25/K5 S160 w128": (1, 25, 5, 160, 64, True, 128),
    "bidirectional S130": (2, 2, 1, 130, 64, False, 0),
    "small head dim hd32 S192 w64": (1, 6, 3, 192, 32, True, 64),
    # the moe role's tiny config (qwen3-moe-30b-a3b smoke): H 4, K 2, hd 16
    "moe smoke heads hd16 S200": (2, 4, 2, 200, 16, True, 0),
    "moe smoke heads hd16 S160 w48": (1, 4, 2, 160, 16, True, 48),
    "hd16 bidirectional S70": (1, 4, 1, 70, 16, False, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_prefill_matches_plain_version(case, dtype):
    B, H, K, S, hd, causal, window = CASES[case]
    _, (q, k, v) = _inputs(B, H, K, S, hd, dtype, seed=21)
    body = flash_ops.body(DTYPES[dtype][1], hd)
    out = tiled_prefill(q, k, v, causal=causal, window=window, body=body)
    _close(attention_ref(q, k, v, causal=causal, window=window).float()
           .numpy(), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_prefill_matches_pallas_kernel(case, dtype):
    B, H, K, S, hd, causal, window = CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(B, H, K, S, hd, dtype, seed=22)
    body = flash_ops.body(DTYPES[dtype][1], hd)
    kern = flash_attention(jq, jk, jv, causal=causal, window=window,
                           block_q=64, block_k=64)
    _close(kern, tiled_prefill(q, k, v, causal=causal, window=window,
                               body=body), dtype)


@pytest.mark.parametrize("S,window", [(1024, 0), (1000, 0), (1100, 512)])
def test_bf16_p_stays_within_tolerance_at_longer_sequences(S, window):
    """Rounding P to bf16 before P V, over many tiles of one row."""
    _, (q, k, v) = _inputs(1, 2, 1, S, 128, "bfloat16", seed=23)
    out = tiled_prefill(q, k, v, causal=True, window=window, body="wgmma")
    _close(attention_ref(q, k, v, causal=True, window=window).float()
           .numpy(), out, "bfloat16")


def test_tile_skipping_keeps_rows_that_see_no_key_in_a_visited_tile():
    """With a window the first visited tile can hold no valid key for a
    row: its p = 1 on -1e30 entries must be wiped out by a later alpha = 0,
    so the model with skipping still equals the plain version."""
    _, (q, k, v) = _inputs(1, 2, 2, 520, 64, "float32", seed=24)
    out = tiled_prefill(q, k, v, causal=True, window=200, body="wgmma")
    ref = attention_ref(q, k, v, causal=True, window=200)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


def test_body_is_chosen_from_dtype_and_head_dim_alone():
    assert flash_ops.body(torch.bfloat16, 128) == "wgmma"
    assert flash_ops.body(torch.bfloat16, 64) == "wgmma"
    assert flash_ops.body(torch.bfloat16, 32) == "simt"
    assert flash_ops.body(torch.bfloat16, 16) == "simt"
    for hd in (16, 32, 64, 128):
        assert flash_ops.body(torch.float32, hd) == "simt"
    assert X.HEAD_DIMS == (16, 32, 64, 128)


@pytest.mark.parametrize("hd", X.HEAD_DIMS)
def test_simt_lanes_cover_every_column_once(hd):
    """The SIMT body's output layout: lane tx of each 16-lane column group
    owns columns tx + 16 c, c < hd / 16 (NC = 1 at hd 16)."""
    nc = hd // 16
    cols = sorted(tx + 16 * c for tx in range(16) for c in range(nc))
    assert cols == list(range(hd))


def test_tma_checks_pass_the_model_layout_and_fused_views():
    qkv = torch.zeros((2, 300, 12, 128), dtype=torch.bfloat16)
    X.check_aligned(flash_ops.NAME, "TMA", qkv[:, :, :8], qkv[:, :, 8:10],
                    qkv[:, :, 10:])
    X.check_aligned(flash_ops.NAME, "TMA",
                    torch.zeros((1, 77, 25, 64), dtype=torch.bfloat16))


def test_tma_checks_reject_what_tma_cannot_describe():
    wide = torch.zeros((1, 64, 4, 72), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        X.check_aligned(flash_ops.NAME, "TMA", wide[..., 1:65])
    odd = torch.zeros((1, 64, 4, 65), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        X.check_aligned(flash_ops.NAME, "TMA", odd[..., :64])


def test_cpu_wrapper_with_views_runs_the_plain_version():
    _, (q, k, v) = _inputs(1, 4, 2, 96, 64, "bfloat16", seed=25)
    qkv = torch.cat([q, k, v], dim=1).transpose(1, 2)   # (B, S, H + 2K, hd)
    before = flash_ops.launches
    out = flash_ops.mha(qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:],
                        causal=True)
    assert torch.equal(out, mha_ref(qkv[:, :, :4], qkv[:, :, 4:6],
                                    qkv[:, :, 6:], causal=True))
    assert flash_ops.launches == before
