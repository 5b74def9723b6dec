"""Build and load the CUDA selection kernels.

``csrc/selection.cu`` has a plain C interface, so it is compiled with
``nvcc`` alone (no PyTorch headers, seconds rather than minutes) into a
shared library and loaded with ``ctypes``.  The build runs on first use,
into ``_build/`` beside this file (listed in ``.gitignore``); the
library's file name carries a hash of the source, so an edited source is
rebuilt and a stale library is never loaded.

Every pointer and the stream are passed as ``c_void_p``; every entry
point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("selection.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each entry point (all return int = cudaError_t).
SIGNATURES = {
    "block_topk": (_P, _I, _P, _P, _I, _I, _I, _P),
    "ef_select_pack": (_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P),
    "ef_block_candidates": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "ef_accum_sparsify": (_P, _I, _P, _P, _P, _P, _P, _L, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, from csrc/")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources (if this exact source is not built yet) and
    return the library's path.  ``verbose`` prints nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libselection-{_digest()}.so"
    log = out.with_suffix(".log")
    if not out.exists():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    if verbose and log.exists():
        print(log.read_text(), end="")
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
