"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel keeps one source, ``kernels/<name>/csrc/<name>.cu``, with a
plain C interface; the attention backward's, ``flash_attention_bwd.cu``,
sits beside the forward's in ``kernels/flash_attention/csrc/`` and
builds as a library of its own. At first use it is compiled for Hopper into a shared
library under ``build/kernels/`` at the root of the checkout, named by a
digest of its source and flags so an edited source is rebuilt, and
loaded with `ctypes`. A source that includes no PyTorch header builds in
seconds; a failed build raises with the compiler's output.

`build` starts one nvcc per source, all together, and waits for all of
them: ``chip_smoke.py`` calls it once so the kernels build in parallel.
Nothing is built or imported from CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NAMES = ("flash_attention", "flash_attention_bwd", "decode_attention",
         "ssm_scan")
#: the kernels whose source lives in another kernel's package
PACKAGES = {"flash_attention_bwd": "flash_attention"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME, else /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def source(name: str) -> Path:
    return KERNELS_DIR / PACKAGES.get(name, name) / "csrc" / f"{name}.cu"


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=NAMES) -> dict[str, Path]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns name -> library path. Raises `RuntimeError` with nvcc's output
    if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        target = library_path(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, target))
    errors = []
    for name, proc, tmp, target in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _libs[name] = lib
        return lib
