"""Prefill attention wrapper: (B, S, H, hd) in and out.

On a CUDA tensor `mha` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the
plain version in ``ref.py``. The kernel reads the model's layout through
strides, so nothing is transposed or copied. ``launches`` counts kernel
launches.

The source has two bodies, picked from the dtype and head dim alone
(`body`): bf16 at hd 64 or 128 runs on the tensor cores (wgmma, tiles
loaded by TMA); f32 and bf16 at hd 32 run the SIMT body. TMA describes a
tensor only when its base address and every stride but the innermost
are multiples of 16 bytes: for the tensor-core body the wrapper checks
that and raises, it never falls back.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.flash_attention.ref import mha_ref

NAME = "flash_attention"
WGMMA_HEAD_DIMS = (64, 128)
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


def body(dtype: torch.dtype, hd: int) -> str:
    """The kernel body that serves this dtype and head dim: "wgmma"
    (tensor cores, TMA) or "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS \
        else "simt"


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
    if body(q.dtype, hd) == "wgmma":
        X.check_aligned(NAME, "TMA", q, k, v)
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
