"""Selective-scan wrapper: (dt, xr, B, C, A, h0) -> (y, h_final).

On CUDA tensors `selective_scan` launches the hand-written kernel
(``csrc/ssm_scan.cu``) or raises; on CPU tensors it runs the plain
version in ``ref.py``. The kernel reads B and C through their strides
(on the model path they are column slices of one projection), takes xr
in bf16 or f32, and masks the ragged tail of S instead of padding it.
Each thread carries R of a channel's N states; `states_per_thread` says
which R the kernel takes for a shape, and `selective_scan_at` forces it.
``launches`` counts kernel launches.

`selective_scan` is differentiable. When grad is enabled and any input
requires it, it runs as an autograd Function: on CUDA tensors its
forward launches the forward kernel, which then also writes the state at
every ``CHUNK``-th step (`selective_scan_states`), and its backward
launches the hand-written backward (``csrc/ssm_scan_bwd.cu``, its own
library, `selective_scan_bwd`) on those states; ``bwd_launches`` counts
those. `bwd_config` says how the backward runs at a shape. On CPU
tensors the same Function runs `ssm_scan_ref` and
`ssm_scan_ref_bwd`, so the CPU tests drive its wiring; a CUDA tensor
never reaches the plain versions. Under ``torch.inference_mode``
(prefill) nothing of that runs and the forward saves no states. A failed
build or launch raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _launch as X
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref, ssm_scan_ref_bwd

NAME = "ssm_scan"
BWD_NAME = "ssm_scan_bwd"
STATES = (8, 16)
#: states per thread the kernel takes (R divides N)
PER_THREAD = (2, 4, 8, 16)
#: ... and the backward kernel
BWD_PER_THREAD = (2, 4)
#: steps between two states the forward saves for the backward (CHUNK in
#: ssm_scan.cu, SAVED in ssm_scan_bwd.cu; a library built with another
#: value refuses the call). Of 16 and 32, timed on an H100, 16 gave the
#: faster backward at hymba-1.5b's training shape and at B 1 x S 2048; at
#: falcon-mamba-7b's, 32 at R 2 was 2.8% faster and cheaper to save
CHUNK = 16
#: what `bwd_config` reports, in the order the C entry writes it
BWD_CONFIG = ("states_per_thread", "sub_chunk", "cluster", "clusters_per_row",
              "smem_bytes", "ctas_per_sm", "ctas")
launches = 0
bwd_launches = 0
_count_lock = threading.Lock()


def _lib():
    lib = _build.load(NAME)
    fn = lib.ssm_scan_fwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 9 + [X.i32] * 5 + [X.i64] * 10
                       + [X.i32, X.ptr])
        states = lib.ssm_scan_states
        states.restype = X.i32
        states.argtypes = [X.i32] * 3
    return lib


def _lib_bwd():
    lib = _build.load(BWD_NAME)
    fn = lib.ssm_scan_bwd
    if fn.argtypes is None:
        fn.restype = X.i32
        fn.argtypes = ([X.i32] + [X.ptr] * 15 + [X.i32] * 5 + [X.i64] * 10
                       + [X.i32, X.ptr])
        lib.ssm_scan_bwd_states.restype = X.i32
        lib.ssm_scan_bwd_states.argtypes = [X.i32] * 3
        lib.ssm_scan_bwd_workspace.restype = X.i64
        lib.ssm_scan_bwd_workspace.argtypes = [X.i32] * 5
        lib.ssm_scan_bwd_config.restype = X.i32
        lib.ssm_scan_bwd_config.argtypes = [X.i32] * 5 + [X.ptr]
    return lib


def states_per_thread(B: int, di: int, N: int) -> int:
    """The R the kernel takes for these sizes on this card (needs the
    built kernel and a CUDA device)."""
    return _lib().ssm_scan_states(B, di, N)


def bwd_states_per_thread(B: int, di: int, N: int) -> int:
    """The R the backward kernel takes for these sizes on this card."""
    return _lib_bwd().ssm_scan_bwd_states(B, di, N)


def bwd_config(B: int, di: int, N: int, *, R: int = 0,
               xdtype=torch.bfloat16) -> dict:
    """How the backward kernel runs at these sizes on this card (R 0:
    its own choice): the keys of ``BWD_CONFIG`` (shared memory a CTA in
    bytes, the CTAs an SM holds, the blocks of a cluster, ...)."""
    out = (ctypes.c_int * len(BWD_CONFIG))()
    rc = _lib_bwd().ssm_scan_bwd_config(X.DTYPE_CODES[xdtype], B, di, N, R,
                                        out)
    X.raise_on(BWD_NAME, rc)
    return dict(zip(BWD_CONFIG, out))


def _check(dt, xr, Bmat, Cmat, A, h0=None):
    """Shapes, devices, dtypes and layouts the kernels take (h0 None: not
    checked); returns the common device."""
    if dt.dim() != 3 or xr.shape != dt.shape:
        raise ValueError(f"{NAME}: dt {tuple(dt.shape)} and xr "
                         f"{tuple(xr.shape)} must be one (B, S, di)")
    B, S, di = dt.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    for name, t, shape in (("Bmat", Bmat, (B, S, N)), ("Cmat", Cmat, (B, S, N)),
                           ("A", A, (di, N)), ("h0", h0, (B, di, N))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    dev = dt.device
    for name, t in (("dt", dt), ("xr", xr), ("Bmat", Bmat), ("Cmat", Cmat),
                    ("A", A), ("h0", h0)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, dt on {dev}")
        if t.dtype != torch.float32 and not (name == "xr"
                                             and t.dtype == torch.bfloat16):
            raise TypeError(f"{NAME}: {name} is {t.dtype}; float32 expected"
                            f"{' (or bfloat16)' if name == 'xr' else ''}")
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{NAME}: the last dimension of {name} must be "
                             f"contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{NAME}: device {dev} not supported")
    return dev


def _forward(dt, xr, Bmat, Cmat, A, h0, R, states=False):
    """One launch of the forward kernel on CUDA tensors: y, h_final and,
    with ``states``, the state entering every ``CHUNK``-th step,
    (B, ceil(S / CHUNK), di, N) f32 (its first entry h0)."""
    N = A.shape[1]
    if N not in STATES:
        raise ValueError(f"{NAME}: state size {N} not in {STATES}")
    B, S, di = dt.shape
    dev = dt.device
    A, h0 = A.contiguous(), h0.contiguous()
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h_final = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    hs = (torch.empty((B, -(-S // CHUNK), di, N), dtype=torch.float32,
                      device=dev) if states else None)
    rc = _lib().ssm_scan_fwd(
        X.DTYPE_CODES[xr.dtype], dt.data_ptr(), xr.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), A.data_ptr(), h0.data_ptr(), y.data_ptr(),
        h_final.data_ptr(), None if hs is None else hs.data_ptr(), CHUNK, B,
        S, di, N, dt.stride(0), dt.stride(1), xr.stride(0), xr.stride(1),
        Bmat.stride(0), Bmat.stride(1), Cmat.stride(0), Cmat.stride(1),
        y.stride(0), y.stride(1), R, X.stream(dev))
    X.raise_on(NAME, rc)
    global launches
    with _count_lock:
        launches += 1
    return (y, h_final, hs) if states else (y, h_final)


def _check_r(R, N, taken):
    if R and (R not in taken or N % R):
        raise ValueError(f"{NAME}: R={R} not taken (one of {taken} dividing "
                         f"N={N})")


def selective_scan_states(dt, xr, Bmat, Cmat, A, h0):
    """The forward kernel with its boundary states on CUDA tensors (one
    launch, no autograd): (y, h_final, hs), hs[:, c] the state entering
    step c * ``CHUNK``, as `selective_scan_bwd` reads it."""
    if _check(dt, xr, Bmat, Cmat, A, h0).type != "cuda":
        raise ValueError(f"{NAME}: the kernel runs on a CUDA device, not "
                         f"{dt.device}")
    return _forward(dt, xr, Bmat, Cmat, A, h0, 0, states=True)


def selective_scan_bwd(dt, xr, Bmat, Cmat, A, hs, dy, dh_final=None, *,
                       R: int = 0):
    """The gradients of `selective_scan` at (dt, xr, Bmat, Cmat, A, h0),
    given the forward's boundary states ``hs`` (`selective_scan_states`),
    dy (B, S, di) f32 (made contiguous in its last dimension if it is not)
    and dh_final (B, di, N) f32 or None (zero): (d(dt), dx in xr's dtype,
    dB, dC, dA, dh0), one launch of the backward kernel (two kernels on
    one stream) on CUDA tensors. R forces the states per thread (one of
    ``BWD_PER_THREAD``; 0: `bwd_states_per_thread`). S = 0 launches
    nothing: the gradients are zero and dh0 is dh_final."""
    dev = _check(dt, xr, Bmat, Cmat, A)
    if dev.type != "cuda":
        raise ValueError(f"{BWD_NAME}: the kernel runs on a CUDA device, not "
                         f"{dev}")
    B, S, di = dt.shape
    N = A.shape[1]
    _check_r(R, N, BWD_PER_THREAD)
    if N not in STATES:
        raise ValueError(f"{BWD_NAME}: state size {N} not in {STATES}")
    if dy.shape != dt.shape or dy.dtype != torch.float32 or dy.device != dev:
        raise ValueError(f"{BWD_NAME}: dy must be ({B}, {S}, {di}) float32 "
                         f"on {dev}")
    if dy.numel() and dy.stride(-1) != 1:
        dy = dy.contiguous()
    want = (B, -(-S // CHUNK), di, N)
    if (hs is None or tuple(hs.shape) != want or hs.dtype != torch.float32
            or hs.device != dev or not hs.is_contiguous()):
        raise ValueError(f"{BWD_NAME}: hs must be the forward's contiguous "
                         f"{want} float32 boundary states on {dev}")
    if dh_final is not None:
        if (tuple(dh_final.shape) != (B, di, N) or dh_final.dtype
                != torch.float32 or dh_final.device != dev):
            raise ValueError(f"{BWD_NAME}: dh_final must be ({B}, {di}, {N}) "
                             f"float32 on {dev}")
        dh_final = dh_final.contiguous()
    ddt = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    dx = torch.empty((B, S, di), dtype=xr.dtype, device=dev)
    dB = torch.empty((B, S, N), dtype=torch.float32, device=dev)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=dev)
    if S == 0:
        dh0 = (torch.zeros((B, di, N), dtype=torch.float32, device=dev)
               if dh_final is None else dh_final.clone())
        return ddt, dx, dB, dC, torch.zeros_like(A, dtype=torch.float32), dh0
    A = A.contiguous()
    dA = torch.empty((di, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, di, N), dtype=torch.float32, device=dev)
    lib = _lib_bwd()
    work = torch.empty(lib.ssm_scan_bwd_workspace(B, S, di, N, R),
                       dtype=torch.float32, device=dev)
    rc = lib.ssm_scan_bwd(
        X.DTYPE_CODES[xr.dtype], dt.data_ptr(), xr.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), A.data_ptr(), hs.data_ptr(), dy.data_ptr(),
        None if dh_final is None else dh_final.data_ptr(), ddt.data_ptr(),
        dx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        dh0.data_ptr(), work.data_ptr(), CHUNK, B, S, di, N, dt.stride(0),
        dt.stride(1), xr.stride(0), xr.stride(1), Bmat.stride(0),
        Bmat.stride(1), Cmat.stride(0), Cmat.stride(1), dy.stride(0),
        dy.stride(1), R, X.stream(dev))
    X.raise_on(BWD_NAME, rc)
    global bwd_launches
    with _count_lock:
        bwd_launches += 1
    return ddt, dx, dB, dC, dA, dh0


class _SelectiveScan(torch.autograd.Function):
    """The scan as one differentiable op: the kernel pair on CUDA tensors,
    `ssm_scan_ref` and `ssm_scan_ref_bwd` on CPU tensors. An unused output
    (h_final, on the training path) reaches the backward as None."""

    @staticmethod
    def forward(ctx, dt, xr, Bmat, Cmat, A, h0):
        ctx.set_materialize_grads(False)
        if dt.device.type == "cpu":
            y, h_final = ssm_scan_ref(dt, xr, Bmat, Cmat, A, h0)
            ctx.save_for_backward(dt, xr, Bmat, Cmat, A, h0)
        else:
            y, h_final, hs = _forward(dt, xr, Bmat, Cmat, A, h0, 0,
                                      states=True)
            ctx.save_for_backward(dt, xr, Bmat, Cmat, A, hs)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        dt, xr, Bmat, Cmat, A, start = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(dt.shape, dtype=torch.float32, device=dt.device)
        if dt.device.type == "cpu":
            grads = ssm_scan_ref_bwd(dt, xr, Bmat, Cmat, A, start, dy,
                                     dh_final)
        else:
            grads = selective_scan_bwd(dt, xr, Bmat, Cmat, A, start, dy,
                                       dh_final)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def _scan(dt, xr, Bmat, Cmat, A, h0, R):
    dev = _check(dt, xr, Bmat, Cmat, A, h0)
    _check_r(R, A.shape[1], PER_THREAD)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, xr, Bmat, Cmat, A, h0)):
        if R:
            raise ValueError(f"{NAME}: R is forced only without autograd")
        return _SelectiveScan.apply(dt, xr, Bmat, Cmat, A, h0)
    if dev.type == "cpu":
        return ssm_scan_ref(dt, xr, Bmat, Cmat, A, h0)
    return _forward(dt, xr, Bmat, Cmat, A, h0, R)


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
