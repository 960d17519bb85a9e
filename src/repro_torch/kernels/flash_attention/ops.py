"""Prefill attention wrapper: (B, S, H, hd) in and out.

On a CUDA tensor `mha` launches the hand-written kernel
(``csrc/flash_attention.cu``) or raises; on a CPU tensor it runs the
plain version in ``ref.py``. The kernel reads the model's layout through
strides, so nothing is transposed or copied. ``launches`` counts kernel
launches.

`mha` is differentiable. When grad is enabled and any of q, k, v
requires it on a CUDA tensor, it runs as an autograd Function whose
forward launches the forward kernel, which then also writes each query
row's log-sum-exp, and whose backward launches the hand-written backward
(``csrc/flash_attention_bwd.cu``, its own library, `mha_bwd`) on that
lse; ``bwd_launches`` counts those. Under ``torch.inference_mode``
(prefill, decode) nothing of that runs and the forward writes no lse.
`mha_with_lse` returns the forward's output and its lse. On CPU tensors
the plain `mha_ref` runs under autograd. A failed build or launch raises;
nothing falls back.

Each source has two bodies, picked from the dtype and head dim alone
(`body` for the forward, `bwd_body` for the backward, the same rule):
bf16 at hd 64 or 128 runs on the tensor cores (wgmma, tiles loaded by
TMA); f32 and bf16 at hd 16 or 32 run the SIMT body. TMA describes a
tensor only when its base address and every stride but the innermost
are multiples of 16 bytes: for a tensor-core body the wrapper checks
that and raises, it never falls back.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.flash_attention.ref import mha_ref, mha_ref_with_lse

NAME = "flash_attention"
BWD_NAME = "flash_attention_bwd"
WGMMA_HEAD_DIMS = (64, 128)
#: the backward pads each (batch, head)'s lse and D rows to a multiple of
#: this many (ROWS_PAD in csrc/flash_attention_bwd.cu)
BWD_ROWS_PAD = 64
launches = 0
bwd_launches = 0
_count_lock = threading.Lock()


def _lib():
    lib = _build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 5 + [X.i32] * 6 + [X.i64] * 12
                       + [X.i32, X.i32, X.ptr])
    return fn


def _lib_bwd():
    lib = _build.load(BWD_NAME)
    fn = lib.flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 10 + [X.i32] * 6 + [X.i64] * 24
                       + [X.i32, X.i32, X.ptr])
    return fn


def body(dtype: torch.dtype, hd: int) -> str:
    """The kernel body that serves this dtype and head dim: "wgmma"
    (tensor cores, TMA) or "simt"."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS \
        else "simt"


def bwd_body(dtype: torch.dtype, hd: int) -> str:
    """The backward kernel's body for this dtype and head dim: "wgmma"
    (tensor cores, TMA, bf16 P and dS) or "simt" (f32 products); the
    forward's rule, so one layer's two kernels run the same kind."""
    return body(dtype, hd)


def _check(q, k, v):
    dev = X.check_float(NAME, q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{NAME}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % K:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} vs kv {tuple(k.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: device {dev} not supported")
    if dev.type == "cuda" and hd not in X.HEAD_DIMS:
        raise ValueError(f"{NAME}: head_dim {hd} not in {X.HEAD_DIMS}")
    return dev


def _strides(*tensors):
    """The (batch, head, seq) element strides of each (B, S, heads, hd)
    tensor, in order."""
    out = []
    for t in tensors:
        out += [t.stride(0), t.stride(2), t.stride(1)]
    return out


def _forward(q, k, v, causal, window, with_lse=False):
    """One launch of the forward kernel on CUDA tensors: out, and with
    ``with_lse`` also each query row's log-sum-exp, (B, H, Sq) f32 in
    natural units of the scaled scores q . k / sqrt(hd)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if body(q.dtype, hd) == "wgmma":
        X.check_aligned(NAME, "TMA", q, k, v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    rc = _lib()(X.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, K, Sq, Sk, hd,
                *_strides(q, k, v, out), int(causal), int(window),
                X.stream(q.device))
    X.raise_on(NAME, rc)
    global launches
    with _count_lock:
        launches += 1
    return (out, lse) if with_lse else out


def mha_with_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """`mha`'s output and each query row's log-sum-exp of the masked,
    scaled scores, (B, H, Sq) f32: one launch of the forward kernel on
    CUDA tensors, `mha_ref_with_lse` on CPU tensors. No autograd."""
    dev = _check(q, k, v)
    if dev.type == "cpu":
        return mha_ref_with_lse(q, k, v, causal=causal, window=window)
    return _forward(q, k, v, causal, window, with_lse=True)


def mha_bwd(q, k, v, out, dout, *, lse, causal: bool = True,
            window: int = 0):
    """dq, dk, dv of `mha` at (q, k, v), given its output ``out``, the
    forward's row log-sum-exp ``lse`` ((B, H, Sq) f32, as `mha_with_lse`
    returns it) and the output's gradient ``dout`` (made contiguous if it
    is not), in q's dtype: one launch of the backward kernel (three
    kernels on one stream) on CUDA tensors. Nothing recomputes the lse."""
    dout = dout.contiguous()
    dev = _check(q, k, v)
    X.check_float(BWD_NAME, q, out, dout)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{BWD_NAME}: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    if dev.type != "cuda":
        raise ValueError(f"{BWD_NAME}: the kernel runs on a CUDA device, "
                         f"not {dev}")
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != dev or not lse.is_contiguous():
        raise ValueError(f"{BWD_NAME}: lse must be the forward's contiguous "
                         f"({B}, {H}, {Sq}) float32 row log-sum-exp on {dev}")
    if bwd_body(q.dtype, hd) == "wgmma":
        X.check_aligned(BWD_NAME, "TMA", q, k, v, out, dout)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    rows = -(-Sq // BWD_ROWS_PAD) * BWD_ROWS_PAD
    work = torch.empty(2 * B * H * rows, dtype=torch.float32, device=dev)
    rc = _lib_bwd()(X.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), work.data_ptr(), B, H, K, Sq, Sk, hd,
                    *_strides(q, k, v, out, dout, dq, dk, dv), int(causal),
                    int(window), X.stream(dev))
    X.raise_on(BWD_NAME, rc)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The kernel pair as one differentiable op on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = mha_bwd(q, k, v, out, dout, lse=lse, causal=ctx.causal,
                             window=ctx.window)
        return dq, dk, dv, None, None


def mha(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, Sk, K, hd) -> (B, S, H, hd) in q.dtype."""
    dev = _check(q, k, v)
    if dev.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
