"""The head_dim-slice decode pair's plain versions (``decode_scores_hd_ref``
and ``decode_values_hd_ref``), composed over every slice of a head as the
mesh decode runs them (the partial scores summed over the slices, then
the softmax and values on each), against the port's one-device decode
attention (``decode_mha_ref``) and the reference's
(``repro.models.layers.decode_attention``), and the wrappers' checks on
the CPU. The kernels themselves are held to these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_mha_ref,
                                                  decode_scores_hd,
                                                  decode_scores_hd_ref,
                                                  decode_values_hd,
                                                  decode_values_hd_ref)

B, W, K, HD = 2, 48, 2, 64
#: f32 sums over the slices in another order than one dot product
TOL = 1e-5


def _slot_pos(fill):
    """A ring of W slots after ``fill`` tokens: wrapped past W, or
    partly filled (-1 = empty)."""
    slots = np.arange(W)
    if fill <= W:
        sp = np.where(slots < fill, slots, -1)
    else:
        sp = (fill - 1) - ((fill - 1 - slots) % W)
    return np.broadcast_to(sp.astype(np.int32), (B, W)).copy()


def _inputs(G, fill, seed=0):
    rng = np.random.default_rng(seed)
    H = K * G
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, W, K, HD)).astype(np.float32)
    v = rng.standard_normal((B, W, K, HD)).astype(np.float32)
    pos = np.full((B,), fill - 1, dtype=np.int32)
    pos[1] = max(fill - 3, 0)            # rows at other positions
    return q, k, v, _slot_pos(fill), pos


def composed(q, k, v, sp, pos, n, window, scores=decode_scores_hd_ref,
             values=decode_values_hd_ref):
    """The pair over ``n`` head_dim slices, as the mesh decode runs it:
    each slice's partial scores, their sum, then the softmax and values
    on each slice, the slices joined again."""
    hs = q.shape[-1] // n
    parts = [slice(j * hs, (j + 1) * hs) for j in range(n)]
    s = sum(scores(q[:, 0, :, p].contiguous(), k[..., p].contiguous())
            for p in parts)
    out = [values(s, v[..., p].contiguous(), sp, pos, head_dim=q.shape[-1],
                  window=window) for p in parts]
    return torch.cat(out, dim=-1)[:, None]


CASES = ([(n, G, window, fill) for n in (2, 4, 8) for G in (1, 2, 4, 7, 8)
          for window in (0, 20) for fill in (W + 13, 30)]
         # hymba-1.5b's G 5 at its slices of hd 64 over model 2, 4 and 16
         # (32, 16 and 4), and slice 4 at G 1 and 8
         + [(n, 5, window, fill) for n in (2, 4, 16) for window in (0, 20)
            for fill in (W + 13, 30)]
         + [(16, G, 20, W + 13) for G in (1, 8)])


@pytest.mark.parametrize("n, G, window, fill", CASES, ids=[
    f"slices{n}-G{G}-w{w}-{'wrapped' if f > W else 'partial'}"
    for n, G, w, f in CASES])
def test_pair_over_slices_equals_the_whole_head(n, G, window, fill):
    """Over 2, 4, 8 and 16 slices of hd 64 (slices of 32 down to 4), G
    1-8, with and without a window, on a ring wrapped past W and one
    partly filled: the one-device decode attention, and the wrappers on
    CPU tensors give the same."""
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _inputs(G, fill))
    want = decode_mha_ref(q, k, v, sp, pos, window=window)
    got = composed(q, k, v, sp, pos, n, window)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    wrapped = composed(q, k, v, sp, pos, n, window, decode_scores_hd,
                       decode_values_hd)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("G, window, n", [(4, 0, 4), (7, 20, 4), (8, 0, 4),
                                          (5, 20, 16)])
def test_pair_matches_the_reference_decode_attention(G, window, n):
    """The composed pair over ``n`` slices against the reference's plain
    layer function (the one GSPMD partitions over head_dim), at f32;
    hymba's G 5 with a window at slice 4."""
    import jax.numpy as jnp

    from repro.models.layers import decode_attention

    arrays = _inputs(G, W + 5, seed=3)
    want = np.asarray(decode_attention(*(jnp.asarray(a) for a in arrays),
                                       window=window))
    q, k, v, sp, pos = (torch.from_numpy(a) for a in arrays)
    got = composed(q, k, v, sp, pos, n, window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_scores_are_unscaled_partial_dot_products():
    q, k, _, _, _ = (torch.from_numpy(a) for a in _inputs(2, W))
    s = decode_scores_hd_ref(q[:, 0, :, :8], k[..., :8])
    want = torch.einsum("bhd,bwhd->bhw", q[:, 0, :, :8],
                        k[..., :8].repeat_interleave(2, dim=2))
    torch.testing.assert_close(s, want)
    assert s.dtype == torch.float32 and s.shape == (B, 2 * K, W)


def test_values_scale_by_the_full_head_dim():
    """The same scores and V under head_dim 64 and 8 differ: the scale is
    1/sqrt of the head_dim it is given, not of the slice."""
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _inputs(1, W))
    s = decode_scores_hd_ref(q[:, 0], k)
    a = decode_values_hd_ref(s, v[..., :8], sp, pos, head_dim=64)
    b = decode_values_hd_ref(s, v[..., :8], sp, pos, head_dim=8)
    want = decode_mha_ref(q, k, v, sp, pos)[:, 0, :, :8]
    torch.testing.assert_close(a, want, atol=TOL, rtol=TOL)
    assert not torch.allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("hs", [16, 4])
def test_values_keep_the_cache_dtype(hs):
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _inputs(2, W))
    s = decode_scores_hd_ref(q[:, 0], k)
    out = decode_values_hd(s, v[..., :hs].to(torch.bfloat16), sp, pos,
                           head_dim=HD)
    assert out.dtype == torch.bfloat16 and out.shape == (B, 2 * K, hs)


def test_slice_4_is_one_the_kernels_take():
    """hymba-1.5b's hd 64 over ``model`` 16 is a slice of 4: in
    ``HD_SLICES``, beside hd 128's slices over 2-16; 12 is not."""
    from repro_torch.kernels.decode_attention.ops import HD_SLICES
    assert 64 // 16 in HD_SLICES and 12 not in HD_SLICES
    assert all(128 // m in HD_SLICES for m in (2, 4, 8, 16))


def test_wrappers_refuse_what_they_do_not_take():
    q, k, v, sp, pos = (torch.from_numpy(a) for a in _inputs(2, W))
    q3 = q[:, 0]
    with pytest.raises(ValueError):
        decode_scores_hd(q, k)                        # q not (B, H, hd_s)
    with pytest.raises(ValueError):
        decode_scores_hd(q3[..., :8].contiguous(), k[..., :16].contiguous())
    with pytest.raises(TypeError):
        decode_scores_hd(q3.double(), k.double())
    s = decode_scores_hd(q3, k)
    with pytest.raises(ValueError):
        decode_values_hd(s.to(torch.bfloat16), v, sp, pos, head_dim=HD)
    with pytest.raises(ValueError):
        decode_values_hd(s, v, sp.long(), pos, head_dim=HD)
    with pytest.raises(ValueError):
        decode_values_hd(s, v, sp, pos[:1], head_dim=HD)
    with pytest.raises(ValueError):
        decode_values_hd(s, v, sp, pos, head_dim=HD // 2)   # below the slice
