"""Checks and argument plumbing shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

#: dtype -> the code the C entry points take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

ptr = ctypes.c_void_p
i32 = ctypes.c_int
i64 = ctypes.c_int64


def check_float(name: str, *tensors) -> torch.device:
    """One device and one float dtype the kernels take, head_dim
    contiguous. Returns the common device."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous")
    return dev


#: bytes: TMA and 16-byte vector loads need base addresses and strides
#: that are multiples of this
ALIGN = 16


def check_aligned(name: str, what: str, *tensors) -> None:
    """Raise unless each tensor's base address, and the byte stride of
    every dimension but the innermost, are multiples of ALIGN bytes, as
    ``what`` needs."""
    for t in tensors:
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                             f"{ALIGN}-byte aligned, which {what} needs")
        for st in t.stride()[:-1]:
            if (st * t.element_size()) % ALIGN:
                raise ValueError(f"{name}: a stride of {st * t.element_size()}"
                                 f" bytes is not a multiple of {ALIGN}, which "
                                 f"{what} needs")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: a C entry point returns this plus a CUresult when a TMA tensor map
#: cannot be built
TMAP_ERROR = 2000


def raise_on(name: str, rc: int) -> None:
    if rc == -1:
        raise ValueError(f"{name}: the kernel does not take these arguments")
    if rc >= TMAP_ERROR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {rc - TMAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
