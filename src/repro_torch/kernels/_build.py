"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel keeps one source, ``kernels/<name>/csrc/<name>.cu``, with a
plain C interface; the backwards' sources, ``flash_attention_bwd.cu`` and
``ssm_scan_bwd.cu``, and the head_dim-slice decode pair's,
``decode_attention_hd.cu``, sit beside their forwards' in their
packages' ``csrc/`` and build as libraries of their own; both attention sources
include the shared header ``hopper.cuh`` beside them. At first use a
source is compiled for Hopper into a shared library under
``build/kernels/`` at the root of the checkout, named by a digest of its
source, of every ``*.cuh`` header in its ``csrc/`` and of the flags, so
an edited source or header is rebuilt, and loaded with `ctypes`. A
source that includes no PyTorch header builds in seconds; a failed
build raises with the compiler's output. ptxas
reports each kernel's registers and spills (``-Xptxas -v``): `LOGS` keeps
the compiler's output of each build this process ran, and `ptxas_report`
reads it.

`build` starts one nvcc per source, all together, and waits for all of
them: ``chip_smoke.py`` calls it once so the kernels build in parallel.
`substitute` has `load` answer another library of a kernel for a while
(a build of a changed copy of its source, for measurements). Nothing is
built or imported from CUDA when this module is imported.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NAMES = ("flash_attention", "flash_attention_bwd", "decode_attention",
         "decode_attention_hd", "ssm_scan", "ssm_scan_bwd")
#: the kernels whose source lives in another kernel's package
PACKAGES = {"flash_attention_bwd": "flash_attention",
            "decode_attention_hd": "decode_attention",
            "ssm_scan_bwd": "ssm_scan"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> nvcc's output of the build this process ran
LOGS: dict[str, str] = {}


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
    """The library's path, named by a digest of the source, the headers
    beside it and the flags."""
    src = source(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> list[tuple[str, int, int, int]]:
    """(mangled kernel name, registers, spill store bytes, spill load
    bytes) of each entry function in an nvcc ``-Xptxas -v`` log."""
    out, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            name, spill = m.group(1), (0, 0)
        elif (m := _SPILL.search(line)) and name:
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := _REGS.search(line)) and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


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
        LOGS[name] = log
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


@contextlib.contextmanager
def substitute(name: str, path: Path):
    """Within the block, `load` answers the library at ``path`` for the
    kernel ``name`` (a build of a changed copy of its source); after it,
    the kernel's own library again."""
    lib = ctypes.CDLL(str(path))
    with _lock:
        before = _libs.get(name)
        _libs[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before
