"""The arithmetic of the cluster-split decode kernel, modelled on the CPU.

``csrc/decode_attention.cu`` splits the W slots of each (kv head, batch)
into C contiguous ranges, one per block of a thread-block cluster. Each
block keeps an f32 state (m, l, acc) over its range; block rank 0
combines them with exp(m_i - M) weights. With bf16 caches the products
run on the tensor cores and P is rounded to bf16 before P V; f32 caches
keep P in f32. `split_decode` below repeats that arithmetic in plain
PyTorch, so the CPU can answer whether the combine keeps the -1e30
masking semantics: a split whose slots are all invalid weighs 0, and with
no valid slot at all the output is the mean of V, as in the plain
version. It is held against the Pallas kernel in interpret mode and
against the port's plain versions.

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import flash_decode
from repro_torch.kernels import _launch as X
from repro_torch.kernels.decode_attention import decode_mha_ref, decode_ref

NEG_INF = -1e30
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def split_ranges(W, C):
    """The slot range [lo, hi) of each block rank, as the kernel cuts it."""
    return [(c * W // C, (c + 1) * W // C) for c in range(C)]


def split_decode(q, k_cache, v_cache, slot_pos, pos, *, window, C,
                 p_bf16=None):
    """q: (B, H, 1, hd); caches (B, K, W, hd); slot_pos (B, W); pos (B,).
    One (m, l, acc) per split in f32, then the cluster combine. P is
    rounded to bf16 before P V when ``p_bf16`` (by default: bf16 caches)."""
    if p_bf16 is None:
        p_bf16 = k_cache.dtype == torch.bfloat16
    B, H, _, hd = q.shape
    K, W = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    ms, ls, accs = [], [], []
    for lo, hi in split_ranges(W, C):
        if hi == lo:                    # an empty range: the initial state
            ms.append(torch.full((B, K, G), NEG_INF))
            ls.append(torch.zeros((B, K, G)))
            accs.append(torch.zeros((B, K, G, hd)))
            continue
        part = s[..., lo:hi]
        m = part.amax(dim=-1)
        p = torch.exp(part - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        pv = p.to(torch.bfloat16).float() if p_bf16 else p
        accs.append(torch.einsum("bkgw,bkwd->bkgd", pv,
                                 v_cache[:, :, lo:hi].float()))
    m_all = torch.stack(ms)                         # (C, B, K, G)
    M = m_all.amax(dim=0)
    wgt = torch.exp(m_all - M)
    L = (torch.stack(ls) * wgt).sum(dim=0)
    A = (torch.stack(accs) * wgt[..., None]).sum(dim=0)
    out = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, 1, hd).to(q.dtype)


#: the f32 SIMT loop's geometry: warps per block, slots per warp step
NW, U = 8, 4


def simt_streams(lo, hi, hd):
    """The slots of [lo, hi) each (warp, lane group) of a block reads in
    the f32 SIMT loop, in order: a slot row is read by min(hd, 32) lanes,
    so at hd 16 each half-warp takes its own slot of a step's pair."""
    sps = 32 // min(hd, 32)
    streams = {}
    for warp in range(NW):
        for sub in range(sps):
            streams[warp, sub] = [
                w0 + u * sps + sub
                for w0 in range(lo + warp * U * sps, hi, NW * U * sps)
                for u in range(U) if w0 + u * sps + sub < hi]
    return streams


def _combine(states):
    """exp(m_i - M)-weighted sum of (m, l, acc) states."""
    m = torch.stack([s[0] for s in states])
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    return (M, (torch.stack([s[1] for s in states]) * w).sum(dim=0),
            (torch.stack([s[2] for s in states]) * w[..., None]).sum(dim=0))


def simt_decode(q, k_cache, v_cache, slot_pos, pos, *, window, C):
    """The f32 SIMT loop, lane group by lane group: an online softmax per
    (warp, lane group) stream, the half-warps combined, then the warps,
    then the cluster's blocks, all with exp(m_i - M) weights."""
    B, H, _, hd = q.shape
    K, W = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float() * (1.0 / math.sqrt(hd))
    s = torch.einsum("bkgd,bkwd->bkgw", qg, k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window > 0:
        valid &= (pos[:, None] - slot_pos) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    v = v_cache.float()
    blocks = []
    for lo, hi in split_ranges(W, C):
        warps = {}
        for (warp, sub), slots in simt_streams(lo, hi, hd).items():
            m = torch.full((B, K, G), NEG_INF)
            l = torch.zeros((B, K, G))
            acc = torch.zeros((B, K, G, hd))
            for w in slots:
                m_new = torch.maximum(m, s[..., w])
                alpha = torch.exp(m - m_new)
                p = torch.exp(s[..., w] - m_new)
                l = l * alpha + p
                acc = acc * alpha[..., None] + p[..., None] * v[:, :, None, w]
                m = m_new
            warps.setdefault(warp, []).append((m, l, acc))
        blocks.append(_combine([_combine(st) for st in warps.values()]))
    _, L, A = _combine(blocks)
    out = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, 1, hd).to(q.dtype)


def ring_slot_pos(W, fill, B):
    slots = np.arange(W)
    if fill <= W:
        sp = np.where(slots < fill, slots, -1)
    else:
        last = fill - 1
        sp = last - ((last - slots) % W)
    return np.broadcast_to(sp.astype(np.int32), (B, W)).copy()


def _inputs(B, H, K, W, hd, fill, pos, dtype, seed):
    rng = np.random.default_rng(seed)
    jd, td, _ = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in [(B, H, 1, hd), (B, K, W, hd), (B, K, W, hd)]]
    sp = ring_slot_pos(W, fill, B)
    p = np.full((B,), pos, np.int32)
    jax_in = [jnp.asarray(a, jd) for a in arrs] + [jnp.asarray(sp),
                                                   jnp.asarray(p)]
    torch_in = [torch.from_numpy(a).to(td) for a in arrs] + [
        torch.from_numpy(sp), torch.from_numpy(p)]
    return jax_in, torch_in


def _close(ref, out, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=tol)


# (B, H, K, W, hd, window, fill, pos, C, Pallas block_k)
CASES = {
    "whole splits empty W512 fill100 C8": (1, 4, 2, 512, 64, 0, 100, 100, 8,
                                           64),
    "wrapped ring window W384 C3": (2, 8, 4, 384, 128, 128, 500, 500, 3, 64),
    "W not a multiple of C W300 C8": (2, 4, 2, 300, 64, 0, 300, 300, 8, 64),
    "no valid slot, mean of V": (2, 4, 2, 256, 64, 0, 0, 0, 8, 64),
    "hymba G5 wrapped window": (1, 25, 5, 256, 64, 256, 257, 256, 2, 64),
    "llama heads full W2048 C8": (1, 32, 8, 2048, 128, 0, 2049, 2048, 8,
                                  256),
    "fewer slots than blocks W5 C8": (1, 4, 2, 5, 32, 0, 5, 5, 8, 5),
    "one block C1": (3, 2, 1, 100, 64, 0, 77, 77, 1, 64),
    # the moe role's tiny config (qwen3-moe-30b-a3b smoke): H 4, K 2, hd 16
    "moe smoke heads hd16 W300 C8": (2, 4, 2, 300, 16, 0, 300, 300, 8, 64),
    "hd16 wrapped ring window W256 C2": (1, 4, 2, 256, 16, 96, 400, 399, 2,
                                         64),
    "hd16 partial fill W512 C8": (1, 8, 1, 512, 16, 0, 37, 37, 8, 64),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_decode_matches_plain_version(case, dtype):
    B, H, K, W, hd, window, fill, pos, C, _ = CASES[case]
    _, t = _inputs(B, H, K, W, hd, fill, pos, dtype, seed=11)
    _close(decode_ref(*t, window=window).float().numpy(),
           split_decode(*t, window=window, C=C), dtype)


@pytest.mark.parametrize("case", list(CASES))
def test_split_decode_matches_pallas_kernel(case):
    B, H, K, W, hd, window, fill, pos, C, block_k = CASES[case]
    j, t = _inputs(B, H, K, W, hd, fill, pos, "float32", seed=12)
    kern = flash_decode(*j, window=window, block_k=block_k)
    _close(kern, split_decode(*t, window=window, C=C), "float32")


@pytest.mark.parametrize("C", [1, 3, 8])
def test_no_valid_slot_gives_the_mean_of_v(C):
    _, (q, kc, vc, sp, p) = _inputs(2, 6, 3, 512, 64, 0, 0, "float32",
                                    seed=13)
    out = split_decode(q, kc, vc, sp, p, window=0, C=C)
    mean = vc.mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
    torch.testing.assert_close(out, mean, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("C", [2, 8])
def test_empty_splits_weigh_nothing(C):
    """A partial fill leaves whole splits with slot_pos = -1: their state is
    m = -1e30 and their weight exp(-1e30 - M) is exactly 0."""
    W, fill = 512, 60
    _, (q, kc, vc, sp, p) = _inputs(1, 4, 2, W, 64, fill, fill, "float32",
                                    seed=14)
    out = split_decode(q, kc, vc, sp, p, window=0, C=C)
    # the filled slots alone give the same output: the empty splits add 0
    alone = decode_ref(q, kc[:, :, :fill], vc[:, :, :fill], sp[:, :fill], p)
    torch.testing.assert_close(out, alone, atol=2e-5, rtol=2e-5)
    assert all(lo >= fill for lo, _ in split_ranges(W, C)[1:])


@pytest.mark.parametrize("hd", X.HEAD_DIMS)
@pytest.mark.parametrize("lo,hi", [(0, 5), (0, 300), (37, 301), (512, 2048)])
def test_simt_streams_cover_every_slot_once(lo, hi, hd):
    slots = sorted(w for st in simt_streams(lo, hi, hd).values() for w in st)
    assert slots == list(range(lo, hi))
    assert len(simt_streams(lo, hi, hd)) == NW * (2 if hd == 16 else 1)


@pytest.mark.parametrize("case", [c for c in CASES if "hd16" in c]
                         + ["W not a multiple of C W300 C8"])
def test_simt_streams_match_plain_version_and_pallas(case):
    """The f32 loop's half-warp streams at hd 16 (and one stream a warp
    above it), combined as the kernel combines them."""
    B, H, K, W, hd, window, fill, pos, C, block_k = CASES[case]
    j, t = _inputs(B, H, K, W, hd, fill, pos, "float32", seed=17)
    out = simt_decode(*t, window=window, C=C)
    _close(decode_ref(*t, window=window).numpy(), out, "float32")
    _close(flash_decode(*j, window=window, block_k=block_k), out, "float32")


@pytest.mark.parametrize("fill", [0, 3, 9])
def test_simt_half_warp_without_a_valid_slot_weighs_nothing(fill):
    """At hd 16 a half-warp whose slots are all invalid (or that has no
    slot at all) keeps m = -1e30: it weighs 0 once the other half saw a
    valid slot, and with no valid slot anywhere the output is the mean
    of V."""
    _, (q, kc, vc, sp, p) = _inputs(1, 4, 2, 9, 16, fill, max(fill - 1, 0),
                                    "float32", seed=18)
    out = simt_decode(q, kc, vc, sp, p, window=0, C=1)
    _close(decode_ref(q, kc, vc, sp, p).numpy(), out, "float32")


def test_split_ranges_cover_every_slot_once():
    for W in (1, 5, 100, 300, 1000, 2048):
        for C in range(1, 9):
            ranges = split_ranges(W, C)
            assert ranges[0][0] == 0 and ranges[-1][1] == W
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            if W >= C:
                assert all(hi > lo for lo, hi in ranges)


@pytest.mark.parametrize("case", ["wrapped ring window W384 C3",
                                  "hymba G5 wrapped window",
                                  "llama heads full W2048 C8"])
def test_bf16_p_stays_within_tolerance(case):
    """Rounding P to bf16 before P V, with f32 inputs so that only P is
    rounded: within the bf16 tolerance of the plain version."""
    B, H, K, W, hd, window, fill, pos, C, _ = CASES[case]
    _, t = _inputs(B, H, K, W, hd, fill, pos, "float32", seed=16)
    _close(decode_ref(*t, window=window).numpy(),
           split_decode(*t, window=window, C=C, p_bf16=True), "bfloat16")


def test_bf16_cache_loads_need_16_byte_alignment():
    cache = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    X.check_aligned("flash_decode", "16-byte cache loads", cache,
                    cache[:, :, 1:3], cache[:1])
    with pytest.raises(ValueError, match="aligned"):
        X.check_aligned("flash_decode", "16-byte cache loads",
                        torch.zeros((2, 64, 4, 72),
                                    dtype=torch.bfloat16)[..., 4:68])
    with pytest.raises(ValueError, match="multiple of 16"):
        X.check_aligned("flash_decode", "16-byte cache loads",
                        torch.zeros((2, 64, 4, 65),
                                    dtype=torch.bfloat16)[..., :64])


def test_model_layout_wrapper_agrees():
    """The plain version in the model's (B, W, K, hd) layout equals the
    split model on the transposed inputs."""
    _, (q, kc, vc, sp, p) = _inputs(2, 8, 2, 300, 64, 350, 349, "float32",
                                    seed=15)
    out = decode_mha_ref(q.transpose(1, 2), kc.transpose(1, 2),
                         vc.transpose(1, 2), sp, p, window=128)
    torch.testing.assert_close(
        out, split_decode(q, kc, vc, sp, p, window=128, C=8).transpose(1, 2),
        atol=2e-5, rtol=2e-5)
