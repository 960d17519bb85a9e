"""Decode attention wrapper: (B, 1, H, hd) against (B, W, K, hd) caches.

On CUDA tensors `decode_mha` launches the hand-written kernel
(``csrc/decode_attention.cu``) or raises; on CPU tensors it runs the
plain version in ``ref.py``. The kernel reads the cache in the model's
layout through strides (the reference wrapper transposes the whole cache
first), and reads ``slot_pos`` and ``pos`` on the device. One launch
splits each (kv head, batch)'s cache across the blocks of a thread-block
cluster (`cluster_size` of them) that combine their partial softmax
states in distributed shared memory. bf16 caches run their products on
the tensor cores and read cache rows in 16-byte pieces, so for them the
wrapper checks that the caches' base addresses and strides are multiples
of 16 bytes and raises otherwise; f32 caches run the SIMT loop.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.decode_attention.ref import decode_mha_ref

NAME = "flash_decode"
SOURCE = "decode_attention"
GROUPS = (1, 2, 4, 5, 8)
launches = 0
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
