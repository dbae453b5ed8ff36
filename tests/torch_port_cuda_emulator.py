"""Build the port's paged attention kernel for the CPU, for tests.

``flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu`` compiles with
the host C++ compiler against the stand-in CUDA headers of
``tests/cuda_emulator/`` (one thread per CUDA thread, barriers for the
block, the warp and the cluster, TF32 ``mma.sync`` emulated). Only the
inline PTX of ``common.cuh`` (``cp.async``, ``mma.sync``) and the
``extern __shared__`` declarations are replaced; everything else is the
source the card builds. The library exports the same C interface as the
card's (``ff_paged_append_*``), called with CPU pointers, plus
``emu_set_sms`` (the streaming multiprocessors the launchers size their
clusters for). Nothing runs when this module is imported.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

from flexflow_tpu_torch.ops.kernels import _build

HEADERS = Path(__file__).resolve().parent / "cuda_emulator"

# the inline-PTX helpers of common.cuh and their CPU stand-ins
_PTX_FREE = """
inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  emu_mma_tf32(c, a, b);
}
"""
_PTX_FUNCTIONS = ("smem_addr", "cp_async16", "cp_async4", "cp_async_commit",
                  "cp_async_wait_all", "mma_tf32")


def _without(text: str, function: str) -> str:
    """``text`` without the definition of ``__device__ ... function(...)``."""
    start = text.index(f" {function}(", text.index("__device__ __forceinline__"))
    start = text.rindex("__device__ __forceinline__", 0, start)
    end = text.index("\n}\n", start) + 3
    return text[:start] + text[end:]


def build(out_dir: Path) -> Path:
    """Compile the checkout's paged kernel source for the CPU into
    ``out_dir``; returns the library's path. Raises if there is no C++
    compiler or the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    common = (_build.CSRC_DIR / "common.cuh").read_text()
    for fn in _PTX_FUNCTIONS:
        common = _without(common, fn)
    common = common.replace("namespace {\n", "namespace {\n" + _PTX_FREE, 1)
    source = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    source = source.replace("extern __shared__ __align__(16) float smem[];",
                            "float* smem = reinterpret_cast<float*>(emu_smem());")
    source = source.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                            "unsigned char* smem_raw = emu_smem();")
    source += '\nextern "C" void emu_set_sms(int n) { emu_sms = n; }\n'
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text(common)
    (out_dir / "paged_attention.cpp").write_text(source)
    lib = out_dir / "libpaged_emulated.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I", str(HEADERS),
           "-o", str(lib), str(out_dir / "paged_attention.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"emulated build failed:\n{done.stderr[-4000:]}")
    return lib


def load(lib: Path) -> ctypes.CDLL:
    """The built library with the argument types of the card's."""
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(handle, name):
            getattr(handle, name).argtypes = argtypes
            getattr(handle, name).restype = ctypes.c_int
    handle.emu_set_sms.argtypes = [ctypes.c_int]
    return handle
