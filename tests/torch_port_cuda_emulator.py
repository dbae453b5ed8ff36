"""Build the port's CUDA kernel sources for the CPU, for tests.

``flexflow_tpu_torch/ops/kernels/csrc/paged_attention.cu`` and
``flash_attention.cu`` compile with the host C++ compiler against the
stand-in CUDA headers of ``tests/cuda_emulator/`` (one thread per CUDA
thread, barriers for the block, the warp and the cluster, TF32
``mma.sync``, mbarriers, TMA tile loads and bf16 and fp16 ``wgmma``
emulated, and each kernel's shared-memory limit kept by device).
Only the inline PTX of ``common.cuh`` (``cp.async``, ``mma.sync``,
``mbarrier``, ``cp.async.bulk.tensor``, ``wgmma``), the ``extern
__shared__`` declarations and the ``<<<...>>>`` launches are replaced;
everything else is the source the card builds. A library exports the same
C interface as the card's (``ff_paged_append_*``, ``ff_flash_*``), called
with CPU pointers, plus ``emu_set_sms`` (the streaming multiprocessors the
launchers size their clusters for) and ``emu_set_device`` (the host
thread's current device, as ``cudaSetDevice``; returns its
``cudaError_t``). Nothing runs when this module is imported.
"""
from __future__ import annotations

import ctypes
import re
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
inline uint32_t smem_addr(const void* p) { return emu_smem_offset(p); }
inline void mbar_init(uint64_t* bar, int count) { emu_mbar_init(bar, count); }
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar, 0); }
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) { emu_mbar_arrive(bar, bytes); }
inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  emu_mbar_wait(bar, parity);
  return true;
}
inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                        int c3) {
  const int c[4] = {c0, c1, c2, c3};
  emu_tma_load(dst, map, bar, c);
}
inline void cp_async_mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar, 0); }
inline float exp2_approx(float x) { return std::exp2(x); }
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait_all() {}
inline void fence_acc(float (&)[32]) {}
template <typename T>
inline void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  emu_wgmma(d, nullptr, a, b, false, std::is_same<T, __half>::value);
}
template <typename T>
inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  emu_wgmma(d, a, 0, b, true, std::is_same<T, __half>::value);
}
"""
_PTX_FUNCTIONS = ("smem_addr", "cp_async16", "cp_async4", "cp_async_commit",
                  "cp_async_wait_all", "mma_tf32", "mbar_init", "mbar_fence_init",
                  "mbar_arrive", "mbar_arrive_expect_tx", "mbar_try_wait",
                  "cp_async_mbar_arrive", "exp2_approx", "tma_load_4d",
                  "wgmma_fence", "wgmma_commit", "wgmma_wait_all", "fence_acc", "wgmma_ss",
                  "wgmma_rs")
# kernel<<<grid, block, smem, stream>>>(args...) -> emu_launch(kernel, grid, ..., args...)
_LAUNCH = re.compile(r"^(\s*)(\S.*?)<<<(.*?)>>>\(", re.M)


def _without(text: str, function: str) -> str:
    """``text`` without the definition of ``__device__ ... function(...)``
    (and its ``template <...>`` line, if it has one)."""
    start = text.index(f" {function}(", text.index("__device__ __forceinline__"))
    start = text.rindex("__device__ __forceinline__", 0, start)
    template = re.search(r"template <[^>]*>\n$", text[:start])
    if template:
        start = template.start()
    end = text.index("\n}\n", start) + 3
    return text[:start] + text[end:]


def build(out_dir: Path, source: str = "paged_attention.cu") -> Path:
    """Compile the checkout's kernel source ``csrc/<source>`` for the CPU
    into ``out_dir``; returns the library's path. Raises if there is no
    C++ compiler or the build fails."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    common = (_build.CSRC_DIR / "common.cuh").read_text()
    for fn in _PTX_FUNCTIONS:
        common = _without(common, fn)
    common = common.replace("namespace {\n", "namespace {\n" + _PTX_FREE, 1)
    text = (_build.CSRC_DIR / source).read_text()
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "float* smem = reinterpret_cast<float*>(emu_smem());")
    text = text.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                        "unsigned char* smem_raw = emu_smem();")
    text = _LAUNCH.sub(r"\1emu_launch(\2, \3, ", text)
    text += ('\nextern "C" void emu_set_sms(int n) { emu_sms = n; }\n'
             'extern "C" int emu_set_device(int d) { return cudaSetDevice(d); }\n')
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(source).stem
    (out_dir / "common.cuh").write_text(common)
    (out_dir / f"{stem}.cpp").write_text(text)
    lib = out_dir / f"lib{stem}_emulated.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-I", str(HEADERS),
           "-o", str(lib), str(out_dir / f"{stem}.cpp")]
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
    handle.emu_set_device.argtypes = [ctypes.c_int]
    handle.emu_set_device.restype = ctypes.c_int
    return handle
