"""Selective-scan wrapper: (dt, xr, B, C, A, h0) -> (y, h_final).

On CUDA tensors `selective_scan` launches the hand-written kernel
(``csrc/ssm_scan.cu``) or raises; on CPU tensors it runs the plain
version in ``ref.py``. The kernel reads B and C through their strides
(on the model path they are column slices of one projection), takes xr
in bf16 or f32, and masks the ragged tail of S instead of padding it.
Each thread carries R of a channel's N states; `states_per_thread` says
which R the kernel takes for a shape, and `selective_scan_at` forces it.
``launches`` counts kernel launches. The kernel has no backward yet: on
CUDA tensors that require grad (with grad enabled) the wrapper raises
`NotImplementedError` rather than return a result autograd cannot
differentiate.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

NAME = "ssm_scan"
STATES = (8, 16)
#: states per thread the kernel takes (R divides N)
PER_THREAD = (2, 4, 8, 16)
launches = 0
_count_lock = threading.Lock()


def _lib():
    lib = _build.load(NAME)
    fn = lib.ssm_scan_fwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 8 + [X.i32] * 4 + [X.i64] * 10
                       + [X.i32, X.ptr])
        states = lib.ssm_scan_states
        states.restype = X.i32
        states.argtypes = [X.i32] * 3
    return lib


def states_per_thread(B: int, di: int, N: int) -> int:
    """The R the kernel takes for these sizes on this card (needs the
    built kernel and a CUDA device)."""
    return _lib().ssm_scan_states(B, di, N)


def _check(dt, xr, Bmat, Cmat, A, h0):
    if dt.dim() != 3 or xr.shape != dt.shape:
        raise ValueError(f"{NAME}: dt {tuple(dt.shape)} and xr "
                         f"{tuple(xr.shape)} must be one (B, S, di)")
    B, S, di = dt.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    for name, t, shape in (("Bmat", Bmat, (B, S, N)), ("Cmat", Cmat, (B, S, N)),
                           ("A", A, (di, N)), ("h0", h0, (B, di, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    dev = dt.device
    for name, t in (("dt", dt), ("xr", xr), ("Bmat", Bmat), ("Cmat", Cmat),
                    ("A", A), ("h0", h0)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, dt on {dev}")
        if t.dtype != torch.float32 and not (name == "xr"
                                             and t.dtype == torch.bfloat16):
            raise TypeError(f"{NAME}: {name} is {t.dtype}; float32 expected"
                            f"{' (or bfloat16)' if name == 'xr' else ''}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{NAME}: the last dimension of {name} must be "
                             f"contiguous")
    return dev


def _scan(dt, xr, Bmat, Cmat, A, h0, R):
    dev = _check(dt, xr, Bmat, Cmat, A, h0)
    N = A.shape[1]
    if R and (R not in PER_THREAD or N % R):
        raise ValueError(f"{NAME}: R={R} not taken (one of {PER_THREAD} "
                         f"dividing N={N})")
    if dev.type == "cpu":
        return ssm_scan_ref(dt, xr, Bmat, Cmat, A, h0)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: device {dev} not supported")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, xr, Bmat, Cmat, A, h0)):
        raise NotImplementedError(f"{NAME}: the backward kernel is not "
                                  f"ported yet; the scan cannot be "
                                  f"differentiated on the card")
    if N not in STATES:
        raise ValueError(f"{NAME}: state size {N} not in {STATES}")
    B, S, di = dt.shape
    A, h0 = A.contiguous(), h0.contiguous()
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    rc = _lib().ssm_scan_fwd(
        X.DTYPE_CODES[xr.dtype], dt.data_ptr(), xr.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), A.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h_final.data_ptr(), B, S, di, N, dt.stride(0), dt.stride(1),
        xr.stride(0), xr.stride(1), Bmat.stride(0), Bmat.stride(1),
        Cmat.stride(0), Cmat.stride(1), y.stride(0), y.stride(1), R,
        X.stream(dev))
    X.raise_on(NAME, rc)
    global launches
    with _count_lock:
        launches += 1
    return y, h_final


def selective_scan(dt, xr, Bmat, Cmat, A, h0):
    """dt: (B, S, di) f32; xr: (B, S, di) f32 or bf16; Bmat, Cmat:
    (B, S, N) f32; A: (di, N) f32 (negative); h0: (B, di, N) f32.
    Returns (y (B, S, di) f32, h_final (B, di, N) f32)."""
    return _scan(dt, xr, Bmat, Cmat, A, h0, 0)


def selective_scan_at(dt, xr, Bmat, Cmat, A, h0, *, R: int = 0):
    """`selective_scan` with R states per thread forced (0: the kernel's
    own choice, as `states_per_thread` gives it). For tests and
    measurements; the model path calls `selective_scan`."""
    return _scan(dt, xr, Bmat, Cmat, A, h0, R)
