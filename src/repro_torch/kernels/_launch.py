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


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(name: str, rc: int) -> None:
    if rc == -1:
        raise ValueError(f"{name}: the kernel does not take these arguments")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
