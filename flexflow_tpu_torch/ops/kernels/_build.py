"""Build and bind the port's CUDA kernels.

The CUDA C++ sources under ``csrc/`` export a plain C interface. At first
use, :func:`load_library` compiles each ``.cu`` file with its own ``nvcc``
for ``sm_90a``, all at once in parallel, into one shared library per
source, loads them with ``ctypes`` and declares every function's
argument types. The libraries land in ``_build/`` beside this file, each
named by a hash of its source, the shared headers and the flags, so an
unchanged checkout builds once and an edited source rebuilds only its
own library. Nothing here runs when the module is imported.

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
import types
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
# (name, argtypes) of every exported function; restype is an int: the
# cudaError_t of a launch, or the answer of a query
SIGNATURES = {
    "ff_paged_append_f32": (
        [_P] * 6  # q, k_cache, v_cache, block_tables, q_positions, out
        + [_I] * 6  # B, W, H, D, bs, MB
        + [_F, _P]  # scale, stream
    ),
    "ff_paged_append_cluster_size": [_I, _I],  # MB, bs
    "ff_paged_append_split_f32": (
        [_P] * 6  # q, k_cache, v_cache, block_tables, q_positions, out
        + [_I] * 8  # B, W, H, D, bs, MB, ctas, cta_cols
        + [_F, _P]  # scale, stream
    ),
    "ff_flash_fwd_f32": (
        [_P] * 5  # q, k, v, o, lse
        + [_I] * 5  # B, Sq, Sk, H, D
        + [_F, _I, _P]  # scale, causal, stream
    ),
    "ff_flash_bwd_dq_f32": (
        [_P] * 7  # q, k, v, dout, lse, delta, dq
        + [_I] * 5  # B, Sq, Sk, H, D
        + [_F, _I, _P]  # scale, causal, stream
    ),
    "ff_flash_bwd_dkv_f32": (
        [_P] * 8  # q, k, v, dout, lse, delta, dk, dv
        + [_I] * 5  # B, Sq, Sk, H, D
        + [_F, _I, _P]  # scale, causal, stream
    ),
}

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None
# seconds the last load_library() call spent compiling (0.0 when every
# library was already built for these sources)
last_build_seconds: Optional[float] = None
# nvcc's stderr of the last compile, every source (ptxas register and
# shared-memory report)
last_build_log: str = ""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def kernel_sources():
    """The ``.cu`` files, one library each."""
    return [p for p in _sources() if p.suffix == ".cu"]


def source_digest(source: Optional[Path] = None) -> str:
    """Hash of one kernel source (every source when None), the shared
    headers and the compiler flags."""
    h = hashlib.sha256()
    for path in _sources():
        if source is None or path == source or path.suffix == ".cuh":
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"libff_{source.stem}_{source_digest(source)}.so"


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


def _compile(sources) -> None:
    """One nvcc per source, all started together; raises if any fails."""
    global last_build_log
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        target = library_path(src)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((target, tmp, cmd, proc))
    logs, failures = [], []
    for target, tmp, cmd, proc in jobs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        target.with_suffix(".log").write_text(err)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    last_build_log = "".join(logs)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library() -> types.SimpleNamespace:
    """Every exported kernel function, by name, from the per-source
    libraries; sources without a current library are compiled first."""
    global _lib, last_build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = kernel_sources()
        t0 = time.perf_counter()
        missing = [s for s in sources if not library_path(s).exists()]
        if missing:
            _compile(missing)
        last_build_seconds = time.perf_counter() - t0
        fns = {}
        for src in sources:
            lib = ctypes.CDLL(str(library_path(src)))
            for name, argtypes in SIGNATURES.items():
                if name in fns or not hasattr(lib, name):
                    continue
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
        absent = sorted(set(SIGNATURES) - set(fns))
        if absent:
            raise RuntimeError(f"kernel functions {absent} are in no built library")
        _lib = types.SimpleNamespace(**fns)
        return _lib
