"""Build and bind the port's CUDA kernels.

The CUDA C++ sources under ``csrc/`` export a plain C interface. At first
use, :func:`load_library` compiles each ``.cu`` file for ``sm_90a`` into
one shared library per source, loads them with ``ctypes`` and declares
every function's argument types. Each source compiles in the parts :data:`PARTS` names
(a source not named there is one part): one ``nvcc -c`` per part, its
flags picking the functions, and so the kernel instances, its object
holds, every part of every source started together; each source's
objects then link into its one library. The flash source builds as its
three forms and the paged source as its six (form x single-pass or
split). ``last_build_part_seconds`` holds each part's compile seconds.
The libraries land in ``_build/`` beside this file, each
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

# each source's parts: file name -> each part's extra nvcc flags (a source
# not named here is one part, with none); the parts' objects link into the
# source's one library
PARTS = {"flash_attention.cu": tuple((f"-DFF_FLASH_FORM={i}",) for i in range(3)),
         "paged_attention.cu": tuple((f"-DFF_PAGED_PART={i}",) for i in range(6))}


def source_parts(source: Path) -> tuple:
    """The flags of each part ``source`` compiles in."""
    return PARTS.get(source.name, ((),))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (name, argtypes) of every exported function; restype is an int: the
# cudaError_t of a launch, or the answer of a query
SIGNATURES = {
    "ff_paged_append_cluster_size": [_I, _I],  # MB, bs
    # which body a flash launch takes: form (0 f32, 1 bf16, 2 f16), kind,
    # q, k, v, dout, out0, out1, D
    "ff_flash_body": [_I, _I] + [_P] * 6 + [_I],
    # blocks an SM holds of a bf16 wgmma flash kernel: kind, D
    "ff_flash_wg_blocks_per_sm": [_I, _I],
}
# the paged kernels, one form per cache element type (q and out fp32)
for _form in ("f32", "bf16", "f16"):
    SIGNATURES.update({
        f"ff_paged_append_{_form}": (
            [_P] * 6  # q, k_cache, v_cache, block_tables, q_positions, out
            + [_I] * 6  # B, W, H, D, bs, MB
            + [_F, _P]  # scale, stream
        ),
        f"ff_paged_append_split_{_form}": (
            [_P] * 6  # q, k_cache, v_cache, block_tables, q_positions, out
            + [_I] * 8  # B, W, H, D, bs, MB, ctas, cta_cols
            + [_F, _P]  # scale, stream
        ),
    })
# the flash kernels, a float32, a bfloat16 and a float16 form of each
for _form in ("f32", "bf16", "f16"):
    SIGNATURES.update({
        f"ff_flash_fwd_{_form}": (
            [_P] * 5  # q, k, v, o, lse
            + [_I] * 5  # B, Sq, Sk, H, D
            + [_F, _I, _P]  # scale, causal, stream
        ),
        f"ff_flash_bwd_dq_{_form}": (
            [_P] * 7  # q, k, v, dout, lse, delta, dq
            + [_I] * 5  # B, Sq, Sk, H, D
            + [_F, _I, _P]  # scale, causal, stream
        ),
        f"ff_flash_bwd_dkv_{_form}": (
            [_P] * 8  # q, k, v, dout, lse, delta, dk, dv
            + [_I] * 5  # B, Sq, Sk, H, D
            + [_F, _I, _P]  # scale, causal, stream
        ),
    })

_lock = threading.Lock()
_lib: Optional[types.SimpleNamespace] = None
# seconds the last load_library() call spent compiling (0.0 when every
# library was already built for these sources)
last_build_seconds: Optional[float] = None
# nvcc's stderr of the last compile, every source (ptxas register and
# shared-memory report)
last_build_log: str = ""
# seconds of each compile of the last build, by source (and part)
last_build_part_seconds: dict = {}


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
    if source is not None:
        h.update(repr(source_parts(source)).encode())
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


def _start(cmd):
    """Start ``cmd``; a thread reads its stderr (ptxas -v fills a pipe)
    and notes when it ended."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0, done = time.perf_counter(), {}

    def wait():
        done["err"] = proc.communicate()[1]
        done["s"] = time.perf_counter() - t0

    reader = threading.Thread(target=wait, daemon=True)
    reader.start()
    return cmd, proc, reader, done


def _compile(sources) -> None:
    """One ``nvcc -c`` per part of every source, all started together,
    then each source's link; raises if any fails."""
    global last_build_log, last_build_part_seconds
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []  # (source, target, tmp, [(part flags, object, started compile)])
    for src in sources:
        target = library_path(src)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        parts = []
        for i, flags in enumerate(source_parts(src)):
            obj = tmp.with_name(f"{tmp.name}.{i}.o")
            parts.append((flags, obj, _start([nvcc, *compile_flags, *flags, "-c", "-o",
                                              str(obj), str(src)])))
        jobs.append((src, target, tmp, parts))
    logs, failures, seconds = [], [], {}
    for src, target, tmp, parts in jobs:
        errs, ok = [], True
        for flags, _, (cmd, proc, reader, done) in parts:
            reader.join()
            errs.append(done["err"])
            label = " ".join(f[2:] for f in flags)  # the part's defines, "-D" dropped
            seconds[f"{src.name}[{label}]" if flags else src.name] = done["s"]
            if proc.returncode != 0:
                ok = False
                failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                                f"{done['err']}")
        if ok:
            cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in parts)]
            link = subprocess.run(cmd, capture_output=True, text=True)
            errs.append(link.stderr)
            if link.returncode != 0:
                ok = False
                failures.append(f"nvcc failed (exit {link.returncode}): {' '.join(cmd)}\n"
                                f"{link.stderr}")
        for _, obj, _ in parts:
            obj.unlink(missing_ok=True)
        logs.extend(errs)
        if not ok:
            tmp.unlink(missing_ok=True)
            continue
        target.with_suffix(".log").write_text("".join(errs))
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    last_build_log = "".join(logs)
    last_build_part_seconds = seconds
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
