"""Probes of the flash kernels' design on one NVIDIA GPU.

    python3 -m flexflow_tpu_torch.tools.flash_probe variants
    python3 -m flexflow_tpu_torch.tools.flash_probe mma-peak

``variants`` builds copies of ``ops/kernels/csrc/flash_attention.cu`` with
one design choice changed each (a text substitution, :data:`VARIANTS`),
all nvcc runs at once, and times the forward, dQ and dK/dV kernels of each
at the training shape (B=32, S=128, H=12, D=64) and at causal B=4 S=512 by
CUDA events over 100 eager calls on one input set, in two rounds (forward
order, then reverse), beside the unchanged source. Each variant is also
held against the plain versions; the ``probe`` variants give wrong results
on purpose (they measure what a part of the arithmetic costs).

``mma-peak`` times a kernel that only issues independent
``mma.sync.m16n8k8`` TF32 products, the rate the tensor-core kernels'
instruction could reach on this card.

Builds land in ``ops/kernels/_build/probe/``; nothing runs at import.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

SPLIT_INT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;"""
SPLIT_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));"""
B_NK = """  split_tf32(p[g * ld + t], f.big[0], f.small[0]);
  split_tf32(p[g * ld + t + 4], f.big[1], f.small[1]);"""
B_KN = """  split_tf32(p[2 * t * ld + g], f.big[0], f.small[0]);
  split_tf32(p[(2 * t + 1) * ld + g], f.big[1], f.small[1]);"""

DQ_A_FROM_SMEM = """      FragA qa, da;
      load_a(qa, my_q + 8 * d8, kLD, scale);
      load_a(da, my_do + 8 * d8, kLD, 1.f);"""
DQ_A_FROM_REGS = """      const FragA& qa = q_frag[d8];
      const FragA& da = do_frag[d8];"""
DQ_ROWS = """  const float* my_do = dos + warp * 16 * kLD;
"""
DQ_ROWS_SPLIT_ONCE = DQ_ROWS + """  FragA q_frag[kNT], do_frag[kNT];  // split once, held for every key tile
#pragma unroll
  for (int d8 = 0; d8 < kNT; ++d8) {
    load_a(q_frag[d8], my_q + 8 * d8, kLD, scale);
    load_a(do_frag[d8], my_do + 8 * d8, kLD, 1.f);
  }
"""

# name -> [(text in the source, replacement)]
VARIANTS = {
    "fwd_key_tile_64": [("constexpr int kFwdKeyTile = 32;", "constexpr int kFwdKeyTile = 64;")],
    "fwd_min_blocks_2": [("kDP <= 64 ? 4 : 1)", "kDP <= 64 ? 2 : 1)")],
    "dkv_query_tile_32": [("constexpr int kDkvQueryTile = 16;", "constexpr int kDkvQueryTile = 32;")],
    "dkv_query_tile_64": [("constexpr int kDkvQueryTile = 16;", "constexpr int kDkvQueryTile = 64;")],
    "dq_key_tile_16": [("constexpr int kDqKeyTile = 32;", "constexpr int kDqKeyTile = 16;")],
    "dq_a_in_registers": [(DQ_ROWS, DQ_ROWS_SPLIT_ONCE), (DQ_A_FROM_SMEM, DQ_A_FROM_REGS)],
    "split_by_cvt": [(SPLIT_INT, SPLIT_CVT)],
    "probe_no_b_split": [
        (B_NK, B_NK.replace("split_tf32(p[g * ld + t], f.big[0], f.small[0]);",
                            "f.big[0] = f.small[0] = __float_as_uint(p[g * ld + t]);")
         .replace("split_tf32(p[g * ld + t + 4], f.big[1], f.small[1]);",
                  "f.big[1] = f.small[1] = __float_as_uint(p[g * ld + t + 4]);")),
        (B_KN, B_KN.replace("split_tf32(p[2 * t * ld + g], f.big[0], f.small[0]);",
                            "f.big[0] = f.small[0] = __float_as_uint(p[2 * t * ld + g]);")
         .replace("split_tf32(p[(2 * t + 1) * ld + g], f.big[1], f.small[1]);",
                  "f.big[1] = f.small[1] = __float_as_uint(p[(2 * t + 1) * ld + g]);")),
    ],
    "probe_one_tf32": [("  mma_tf32(c, a.big, b.small);\n  mma_tf32(c, a.small, b.big);\n", "")],
}

MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void mma_loop(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(threadIdx.x * 2e-3f + i);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of one launch of blocks x threads, after a warm-up launch
extern "C" float ff_mma_peak_ms(int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  mma_loop<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, s, e);
  cudaFree(out);
  return ms;
}
"""


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _compile(named_sources):
    """{name: .so path} for {name: CUDA source text}, one nvcc each, in parallel."""
    from flexflow_tpu_torch.ops.kernels import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the probes build CUDA code")
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in named_sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        so = out_dir / f"{name}.so"
        # the copies build beside the others, so the shared headers come from csrc/
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(so), str(src)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    built = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-4000:]}")
        built[name] = (so, err)
    return built


def _registers(ptxas_log: str, kernel: str) -> str:
    """ptxas's register count of ``kernel`` (and its spill stores, if any)."""
    lines = ptxas_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            spill = ""
            for later in lines[i + 1:i + 5]:
                if "spill stores" in later and not later.strip().startswith("0 bytes stack"):
                    spill = " (" + later.strip().split(",")[1].strip() + ")"
                if "Used" in later and "registers" in later:
                    return later.split("Used", 1)[1].split(",")[0].strip() + spill
    return "?"


def variants() -> int:
    import torch

    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 2
    base = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    sources = {"source": base}
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    libs = {}
    for name, (so, log) in _compile(sources).items():
        lib = ctypes.CDLL(str(so))
        for fn in ("ff_flash_fwd_f32", "ff_flash_bwd_dq_f32", "ff_flash_bwd_dkv_f32"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        print(f"{name}: registers fwd<64> {_registers(log, 'flash_fwd_tc_kernelILi64')}, "
              f"dq<64> {_registers(log, 'flash_bwd_dq_tc_kernelILi64')}, "
              f"dkv<64> {_registers(log, 'flash_bwd_dkv_tc_kernelILi64')}")

    def run_fwd(lib, q, k, v, causal, scale):
        b, sq, h, d = q.shape
        o, lse = torch.empty_like(q), torch.empty(b, sq, h, device=q.device)
        rc = lib.ff_flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b, sq, k.shape[1], h, d, scale, int(causal),
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"forward launch failed: {rc}")
        return o

    def run_dq(lib, q, k, v, do, lse, delta, causal, scale):
        b, sq, h, d = q.shape
        dq = torch.empty_like(q)
        rc = lib.ff_flash_bwd_dq_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq,
                                     k.shape[1], h, d, scale, int(causal),
                                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dQ launch failed: {rc}")
        return dq

    def run_dkv(lib, q, k, v, do, lse, delta, causal, scale):
        b, sq, h, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = lib.ff_flash_bwd_dkv_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), b, sq, k.shape[1], h, d, scale, int(causal),
                                      torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dK/dV launch failed: {rc}")
        return dk, dv

    def event_ms(fn, iters=100):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    print(_card())
    for b, s, h, d, causal in [(32, 128, 12, 64, False), (4, 512, 12, 64, True)]:
        gen = torch.Generator().manual_seed(1)
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen).cuda() for _ in range(4))
        scale = d ** -0.5
        po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
        delta = fa.flash_delta(do, po)
        bwd = (q, k, v, do, plse, delta, causal, scale)
        pdq, pdk, pdv = fa.reference_flash_backward(*bwd)
        times = {name: [] for name in libs}
        for order in (list(libs), list(reversed(list(libs)))):
            for name in order:
                lib = libs[name]
                times[name].append((
                    event_ms(lambda: run_fwd(lib, q, k, v, causal, scale)),
                    event_ms(lambda: run_dq(lib, *bwd)),
                    event_ms(lambda: run_dkv(lib, *bwd))))
        for name, lib in libs.items():
            o = run_fwd(lib, q, k, v, causal, scale)
            dq = run_dq(lib, *bwd)
            dk, dv = run_dkv(lib, *bwd)
            err = max(float((got - want).abs().max())
                      for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)))
            print(f"B={b} S={s} causal={causal} {name:18s} ms "
                  + "  ".join(f"{kernel} " + " ".join(f"{t[i]:.4f}" for t in times[name])
                              for i, kernel in enumerate(("forward", "dQ", "dK/dV")))
                  + f"  max abs err {err:.2e}")
    return 0


def mma_peak() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 2
    (so, _), = _compile({"mma_peak": MMA_PEAK_CU}).values()
    lib = ctypes.CDLL(str(so))
    lib.ff_mma_peak_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(_card())
    for warps in (1, 2, 4, 8):
        blocks, iters = 4 * sms, 20000
        ms = lib.ff_mma_peak_ms(blocks, 32 * warps, iters)
        flops = blocks * warps * iters * 8 * (16 * 8 * 8 * 2)
        print(f"{warps} warps a block, {blocks} blocks: {flops / ms / 1e9:.1f} TFLOP/s "
              f"(mma.sync m16n8k8 TF32, {ms:.3f} ms)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["variants", "mma-peak"])
    args = ap.parse_args(argv)
    return variants() if args.probe == "variants" else mma_peak()


if __name__ == "__main__":
    sys.exit(main())
