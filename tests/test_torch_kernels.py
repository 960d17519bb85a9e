"""The attention kernels' plain versions and CPU wrappers against the
reference's oracles, and on small shapes against the Pallas kernels in
interpret mode, as tests/test_kernels.py runs them.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_ref as ref_decode
from repro.kernels.decode_attention import flash_decode
from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention
from repro_torch.kernels.decode_attention import decode_mha, decode_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref, mha
from repro_torch.kernels.flash_attention import ops as flash_ops

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

FLASH_SHAPES = [
    (2, 4, 2, 256, 256, 64, True, 0),
    (1, 4, 4, 128, 128, 64, False, 0),     # MHA, bidirectional
    (2, 8, 2, 256, 256, 128, True, 96),    # GQA + SWA
    (1, 2, 1, 200, 200, 64, True, 0),      # ragged seq
    (1, 6, 3, 192, 192, 32, True, 64),     # small head_dim
]
DECODE_SHAPES = [
    (2, 4, 2, 512, 64, 0, 512),
    (2, 4, 2, 512, 64, 0, 200),            # partially filled cache
    (1, 8, 4, 384, 128, 128, 500),         # SWA + wrapped ring
    (3, 2, 1, 100, 64, 0, 77),             # ragged width
]


def _draw(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    jd, td, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(ref, out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


def ring_slot_pos(W, fill, B):
    slots = np.arange(W)
    if fill <= W:
        sp = np.where(slots < fill, slots, -1)
    else:
        last = fill - 1
        sp = last - ((last - slots) % W)
    return np.broadcast_to(sp.astype(np.int32), (B, W)).copy()


def _flash_inputs(shape, dtype, seed=0):
    B, H, K, Sq, Sk, hd, _, _ = shape
    return _draw(seed, [(B, H, Sq, hd), (B, K, Sk, hd), (B, K, Sk, hd)], dtype)


def _decode_inputs(shape, dtype, seed=3):
    B, H, K, W, hd, _, fill = shape
    (jq, jk, jv), (tq, tk, tv) = _draw(
        seed, [(B, H, 1, hd), (B, K, W, hd), (B, K, W, hd)], dtype)
    sp = ring_slot_pos(W, fill, B)
    pos = np.full((B,), fill, np.int32)
    return (jq, jk, jv, jnp.asarray(sp), jnp.asarray(pos)), \
        (tq, tk, tv, torch.from_numpy(sp), torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_attention_ref_matches_reference_oracle(dtype, shape):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(shape, dtype)
    _close(ref_attention(jq, jk, jv, causal=causal, window=window),
           attention_ref(tq, tk, tv, causal=causal, window=window), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [FLASH_SHAPES[3], FLASH_SHAPES[4]])
def test_attention_ref_matches_pallas_kernel(dtype, shape):
    causal, window = shape[6], shape[7]
    (jq, jk, jv), (tq, tk, tv) = _flash_inputs(shape, dtype, seed=1)
    kern = flash_attention(jq, jk, jv, causal=causal, window=window,
                           block_q=64, block_k=64)
    _close(kern, attention_ref(tq, tk, tv, causal=causal, window=window),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_ref_matches_reference_oracle(dtype, shape):
    window = shape[5]
    j, t = _decode_inputs(shape, dtype)
    _close(ref_decode(*j, window=window), decode_ref(*t, window=window),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [DECODE_SHAPES[2], DECODE_SHAPES[3]])
def test_decode_ref_matches_pallas_kernel(dtype, shape):
    window = shape[5]
    j, t = _decode_inputs(shape, dtype, seed=4)
    kern = flash_decode(*j, window=window, block_k=64)
    _close(kern, decode_ref(*t, window=window), dtype)


def test_cpu_wrappers_run_plain_versions_without_launching():
    flash0, decode0 = flash_ops.launches, decode_ops.launches
    _, (q, k, v) = _flash_inputs(FLASH_SHAPES[2], "float32")
    out = mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              window=96)
    ref = attention_ref(q, k, v, window=96).transpose(1, 2)
    assert torch.equal(out, ref)
    _, (q, kc, vc, sp, pos) = _decode_inputs(DECODE_SHAPES[2], "float32")
    out = decode_mha(q.transpose(1, 2), kc.transpose(1, 2),
                     vc.transpose(1, 2), sp, pos, window=128)
    assert torch.equal(out, decode_ref(q, kc, vc, sp, pos,
                                       window=128).transpose(1, 2))
    assert (flash_ops.launches, decode_ops.launches) == (flash0, decode0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 32))
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(TypeError, match="dtype"):
        mha(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError, match="mixed"):
        mha(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        mha(q.transpose(2, 3), kv, kv)
    with pytest.raises(ValueError):
        mha(q, torch.zeros((1, 8, 3, 32)), torch.zeros((1, 8, 3, 32)))
    sp = torch.zeros((1, 8), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="slot_pos"):
        decode_mha(q[:, :1], kv, kv, sp.long(), pos)
    with pytest.raises(ValueError, match="pos"):
        decode_mha(q[:, :1], kv, kv, sp, torch.zeros((2,), dtype=torch.int32))
