"""Decode attention wrapper: (B, 1, H, hd) against (B, W, K, hd) caches.

On CUDA tensors `decode_mha` launches the hand-written kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs the
plain version in ``ref.py``. The kernel reads the cache in the model's
layout through strides (the reference wrapper transposes the whole cache
first), and reads ``slot_pos`` and ``pos`` on the device. One launch
splits each (kv head, batch)'s cache across the blocks of a thread-block
cluster (`cluster_size` of them) that combine their partial softmax
states in distributed shared memory. bf16 caches run their products on
the tensor cores and read cache rows in vector pieces of up to 16 bytes
(4 and 8 bytes at head_dim 16), so for them the wrapper checks that the
caches' base addresses and strides are multiples of 16 bytes and raises
otherwise; f32 caches run the SIMT loop, two slots a warp step at
head_dim 16.
``launches`` counts kernel launches.

`decode_scores_hd` and `decode_values_hd` run one token's attention on
a head_dim slice of every head (the decode cache's layout on a mesh,
head_dim over ``model``), from ``csrc/decode_attention_hd.cu``: the
partial scores, which the caller sums over the ranks, then the softmax
and the values. The scores kernel reads K rows in vectors of 16 bytes (8
at a bf16 slice of 4), so its wrapper checks that alignment. The same
rule: the kernel on CUDA tensors, the plain versions (``ref.py``) on CPU
tensors, never a fallback.
``scores_launches`` and ``values_launches`` count their launches.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.decode_attention.ref import (decode_mha_ref,
                                                      decode_scores_hd_ref,
                                                      decode_values_hd_ref)

NAME = "flash_decode"
SOURCE = "decode_attention"
GROUPS = (1, 2, 4, 5, 6, 7, 8)
SCORES_NAME, VALUES_NAME = "decode_scores_hd", "decode_values_hd"
HD_SOURCE = "decode_attention_hd"
#: the head_dim slices the pair takes (hd 128 over ``model`` 16 .. 2, hd
#: 64 over 16: hymba-1.5b's)
HD_SLICES = (4, 8, 16, 32, 64)
HD_GROUPS = tuple(range(1, 9))
launches = 0
scores_launches = 0
values_launches = 0
_count_lock = threading.Lock()


def _lib():
    lib = _build.load(SOURCE)
    fn = lib.flash_decode_fwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 6 + [X.i32] * 5 + [X.i64] * 11
                       + [X.i32, X.ptr])
    return fn


def body(dtype: torch.dtype) -> str:
    """The loop that serves caches of this dtype: "mma" (tensor cores) for
    bf16, "simt" for f32."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def cluster_size(W: int, B: int, K: int) -> int:
    """The blocks of the cluster that split a cache of W slots of each of
    B * K (batch, kv head) pairs, as the kernel chooses them on this card
    (needs the built kernel)."""
    fn = _build.load(SOURCE).flash_decode_cluster_size
    fn.restype, fn.argtypes = X.i32, [X.i32] * 3
    return fn(W, B, K)


def decode_mha(q, k_cache, v_cache, slot_pos, pos, *, window: int = 0):
    """q: (B, 1, H, hd); caches: (B, W, K, hd); slot_pos: (B, W) int32;
    pos: (B,) int32. Returns (B, 1, H, hd) in q.dtype."""
    dev = X.check_float(NAME, q, k_cache, v_cache)
    if (q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4
            or k_cache.shape != v_cache.shape):
        raise ValueError(f"{NAME}: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, hd = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd or H % K:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    for name, t, shape in (("slot_pos", slot_pos, (B, W)), ("pos", pos, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{NAME}: {name} must be int32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{NAME}: {name} must be contiguous in its last dim")
    if dev.type == "cpu":
        return decode_mha_ref(q, k_cache, v_cache, slot_pos, pos,
                              window=window)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: device {dev} not supported")
    if hd not in X.HEAD_DIMS or H // K not in GROUPS:
        raise ValueError(f"{NAME}: head_dim {hd} / group {H // K} not supported")
    if body(q.dtype) == "mma":
        X.check_aligned(NAME, "16-byte cache loads", k_cache, v_cache)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    rc = _lib()(X.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                v_cache.data_ptr(), slot_pos.data_ptr(), pos.data_ptr(),
                out.data_ptr(), B, H, K, W, hd,
                q.stride(0), q.stride(2),
                k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
                v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
                out.stride(0), out.stride(2), slot_pos.stride(0),
                int(window), X.stream(dev))
    X.raise_on(NAME, rc)
    global launches
    with _count_lock:
        launches += 1
    return out


def _lib_hd(name):
    fn = getattr(_build.load(HD_SOURCE), name)
    if fn.argtypes is None:
        fn.restype = X.i32
        if name == SCORES_NAME:
            fn.argtypes = ([X.i32] + [X.ptr] * 3 + [X.i32] * 5 + [X.i64] * 5
                           + [X.ptr])
        else:
            fn.argtypes = ([X.i32] + [X.ptr] * 5 + [X.i32] * 5
                           + [X.i64] * 8 + [X.i32, ctypes.c_float, X.ptr])
    return fn


def _check_slice(name, dev, H, K, hs):
    if dev.type != "cuda":
        raise ValueError(f"{name}: device {dev} not supported")
    if hs not in HD_SLICES or H // K not in HD_GROUPS:
        raise ValueError(f"{name}: head_dim slice {hs} / group {H // K} not "
                         f"supported (slices {HD_SLICES}, groups 1-8)")


def decode_scores_hd(q, k_cache):
    """q: (B, H, hd_s); k_cache: (B, W, K, hd_s), one head_dim slice of
    every head. Returns (B, H, W) f32: q . k over the slice, unscaled,
    for every slot."""
    name = SCORES_NAME
    dev = X.check_float(name, q, k_cache)
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, H, hs = q.shape
    W, K = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != hs or H % K or W == 0):
        raise ValueError(f"{name}: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)}")
    if dev.type == "cpu":
        return decode_scores_hd_ref(q, k_cache)
    _check_slice(name, dev, H, K, hs)
    # a K row is read in vectors of up to 16 bytes: 8 at a bf16 slice of 4
    vec = min(X.ALIGN, hs * k_cache.element_size())
    X.check_aligned(name, f"{vec}-byte cache loads", k_cache, align=vec)
    out = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    rc = _lib_hd(name)(X.DTYPE_CODES[q.dtype], q.data_ptr(),
                       k_cache.data_ptr(), out.data_ptr(), B, H, K, W, hs,
                       q.stride(0), q.stride(1), k_cache.stride(0),
                       k_cache.stride(1), k_cache.stride(2), X.stream(dev))
    X.raise_on(name, rc)
    global scores_launches
    with _count_lock:
        scores_launches += 1
    return out


def decode_values_hd(scores, v_cache, slot_pos, pos, *, head_dim: int,
                     window: int = 0):
    """scores: (B, H, W) f32, q . k over the whole head_dim (the partial
    scores summed over every slice); v_cache: (B, W, K, hd_s); slot_pos:
    (B, W) int32; pos: (B,) int32. Returns (B, H, hd_s) in v_cache's
    dtype: the softmax of the valid slots' scores over sqrt(``head_dim``)
    times V over the slice."""
    name = VALUES_NAME
    dev = X.check_float(name, v_cache)
    if (scores.dim() != 3 or v_cache.dim() != 4
            or scores.dtype != torch.float32 or scores.device != dev
            or scores.stride(-1) != 1):
        raise ValueError(f"{name}: scores {scores.dtype} "
                         f"{tuple(scores.shape)} on {scores.device} (f32, "
                         f"last dim contiguous), cache "
                         f"{tuple(v_cache.shape)} on {dev}")
    B, H, W = scores.shape
    K, hs = v_cache.shape[2], v_cache.shape[3]
    if (v_cache.shape[0] != B or v_cache.shape[1] != W or H % K or W == 0
            or head_dim < hs):
        raise ValueError(f"{name}: scores {tuple(scores.shape)} vs cache "
                         f"{tuple(v_cache.shape)}, head_dim {head_dim}")
    for what, t, shape in (("slot_pos", slot_pos, (B, W)),
                           ("pos", pos, (B,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev):
            raise ValueError(f"{name}: {what} must be int32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} must be contiguous in its last "
                             f"dim")
    if dev.type == "cpu":
        return decode_values_hd_ref(scores, v_cache, slot_pos, pos,
                                    head_dim=head_dim, window=window)
    _check_slice(name, dev, H, K, hs)
    out = torch.empty((B, H, hs), dtype=v_cache.dtype, device=dev)
    rc = _lib_hd(name)(X.DTYPE_CODES[v_cache.dtype], scores.data_ptr(),
                       v_cache.data_ptr(), slot_pos.data_ptr(),
                       pos.data_ptr(), out.data_ptr(), B, H, K, W, hs,
                       scores.stride(0), scores.stride(1),
                       v_cache.stride(0), v_cache.stride(1),
                       v_cache.stride(2), slot_pos.stride(0),
                       out.stride(0), out.stride(1), int(window),
                       1.0 / math.sqrt(head_dim), X.stream(dev))
    X.raise_on(name, rc)
    global values_launches
    with _count_lock:
        values_launches += 1
    return out
