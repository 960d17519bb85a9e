"""Prefill attention wrapper: (B, S, H, hd) in and out.

On a CUDA tensor `mha` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the
plain version in ``ref.py``. The kernel reads the model's layout through
strides, so nothing is transposed or copied. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.flash_attention.ref import mha_ref

NAME = "flash_attention"
launches = 0
_count_lock = threading.Lock()


def _lib():
    lib = _build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 4 + [X.i32] * 6 + [X.i64] * 12
                       + [X.i32, X.i32, X.ptr])
    return fn


def mha(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, Sk, K, hd) -> (B, S, H, hd) in q.dtype."""
    dev = X.check_float(NAME, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{NAME}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs kv {tuple(k.shape)}")
    if dev.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: device {dev} not supported")
    if hd not in X.HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {X.HEAD_DIMS}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for t in (q, k, v, out):              # (batch, head, seq) strides
        strides += [t.stride(0), t.stride(2), t.stride(1)]
    rc = _lib()(X.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, H, K, Sq, Sk, hd, *strides,
                int(causal), int(window), X.stream(dev))
    X.raise_on(NAME, rc)
    global launches
    with _count_lock:
        launches += 1
    return out
