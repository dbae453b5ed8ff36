"""Build and bind the port's CUDA kernels.

The CUDA C++ sources under ``csrc/`` export a plain C interface. At first
use, :func:`load_library` compiles them with ``nvcc`` for ``sm_90a`` into
one shared library, loads it with ``ctypes`` and declares every
function's argument types. The library lands in ``_build/`` beside this
file, named by a hash of the sources and flags, so an unchanged checkout
builds once and an edited source rebuilds. Nothing here runs when the
module is imported.

A missing ``nvcc`` or a failed build raises: there is no fallback to the
plain PyTorch versions on a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (name, argtypes) of every exported function; restype is the cudaError_t
SIGNATURES = {
    "ff_paged_append_f32": (
        [_P] * 6  # q, k_cache, v_cache, block_tables, q_positions, out
        + [_I] * 6  # B, W, H, D, bs, MB
        + [_F, _P]  # scale, stream
    ),
    "ff_paged_append_split_f32": (
        [_P] * 8  # q, k_cache, v_cache, block_tables, q_positions, acc, m, l
        + [_I] * 8  # B, W, H, D, bs, MB, S, bps
        + [_F, _P]  # scale, stream
    ),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last load_library() call spent compiling (0.0 when the
# library was already built for these sources)
last_build_seconds: Optional[float] = None
# nvcc's stderr of the last compile (ptxas register/shared-memory report)
last_build_log: str = ""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_digest() -> str:
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then the
    toolkit's default install path."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _compile(target: Path) -> None:
    global last_build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the paged attention kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_log = proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    target.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    global _lib, last_build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libff_kernels_{source_digest()}.so"
        t0 = time.perf_counter()
        if not target.exists():
            _compile(target)
        last_build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
