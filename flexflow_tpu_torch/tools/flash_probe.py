"""Probes of the flash kernels' design on one NVIDIA GPU.

    python3 -m flexflow_tpu_torch.tools.flash_probe variants [NAME ...]
    python3 -m flexflow_tpu_torch.tools.flash_probe mma-peak
    python3 -m flexflow_tpu_torch.tools.flash_probe wgmma-peak

``variants`` builds copies of ``ops/kernels/csrc/flash_attention.cu`` and
the ``csrc/common.cuh`` it includes with one design choice changed each (a
text substitution in the source it names, :data:`VARIANTS`), all nvcc
runs at once (every variant, or the NAMEs given), and times the
forward, dQ and dK/dV kernels of each, fp32 and bf16 forms, at the
training shape (B=32, S=128, H=12, D=64) and at causal B=4 S=512: device
ms a call, a CUDA graph of 16 calls over 3 copies of the inputs (past the
50 MB L2) replayed between CUDA events, in two rounds (forward order,
then reverse), beside the unchanged source. The ``wg_`` variants change
the bf16 wgmma bodies (warpgroups a block, blocks an SM, ring depth, tile
of the other axis, who starts the copies, the accurate exp2, how dQ reads
its lse and delta rows), the others
the mma.sync bodies. Each variant is also held against the plain
versions; the ``probe``
variants give wrong results on purpose (they measure what a part of the
arithmetic costs).

``mma-peak`` times a kernel that only issues independent
``mma.sync.m16n8k8`` TF32 products, the rate the mma.sync bodies'
instruction could reach on this card. ``wgmma-peak`` does the same for
the wgmma bodies' instruction, bf16 ``wgmma`` m64n64k16 with both
operands in shared memory or A in registers (``common.cuh``'s
``wgmma_ss`` and ``wgmma_rs``), 1 or 2 warpgroups a block.

Builds land in ``ops/kernels/_build/probe/``; nothing runs at import.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
import sys

SPLIT_INT = """  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;"""
SPLIT_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(rest));"""
B_NK = """  split_in(p[g * ld + t], 1.f, f.big[0], f.small[0]);
  split_in(p[g * ld + t + 4], 1.f, f.big[1], f.small[1]);"""
B_KN = """  split_in(p[2 * t * ld + g], 1.f, f.big[0], f.small[0]);
  split_in(p[(2 * t + 1) * ld + g], 1.f, f.big[1], f.small[1]);"""

DQ_A_FROM_SMEM = """      FragA qa, da;
      load_a(qa, my_q + 8 * d8, kLD, kE ? 1.f : scale);
      load_a(da, my_do + 8 * d8, kLD, 1.f);"""
DQ_A_FROM_REGS = """      const FragA& qa = q_frag[d8];
      const FragA& da = do_frag[d8];"""
DQ_ROWS = """  const T* my_do = dos + warp * 16 * kLD;
"""
DQ_ROWS_SPLIT_ONCE = DQ_ROWS + """  FragA q_frag[kNT], do_frag[kNT];  // split once, held for every key tile
#pragma unroll
  for (int d8 = 0; d8 < kNT; ++d8) {
    load_a(q_frag[d8], my_q + 8 * d8, kLD, kE ? 1.f : scale);
    load_a(do_frag[d8], my_do + 8 * d8, kLD, 1.f);
  }
"""

# regions of the wgmma bodies that the probe variants cut (each ends with
# the close of the warpgroup's per-tile block, which the cut puts back)
WG_FWD_PRODUCTS = "      // S = Q K^T, one exact product (bf16 x bf16 into fp32)\n"
WG_FWD_PV = "      // O = corr O + P V, P in two bf16 halves (lo, then hi), V read MN-major\n"
WG_FWD_END = "      for (int c = 0; c < kNC; ++c) fence_acc(acc[c]);\n    }\n    __syncwarp();\n"
WG_FWD_PV_LO = "          wgmma_rs(acc[c], pl[ks], wg_desc_mn<kBK>(vt, 16 * ks, c));\n"
WG_DKV_PRODUCTS = "      // S^T = K Q^T and dP^T = V dO^T, one exact product each\n"
WG_DKV_RS = "      // dV += P^T dO and dK += dS^T Q (scaled at the store), P^T and dS^T in\n"
WG_DKV_END = "        fence_acc(dk_acc[c]);\n      }\n    }\n    __syncwarp();\n"
WG_DKV_RS_LO = ("          wgmma_rs(dv_acc[c], pl[kk], wg_desc_mn<kBQ>(dot, 16 * kk, c));\n"
                "          wgmma_rs(dv_acc[c], ph[kk], wg_desc_mn<kBQ>(dot, 16 * kk, c));\n"
                "          wgmma_rs(dk_acc[c], dl[kk], wg_desc_mn<kBQ>(qt, 16 * kk, c));\n")
WG_DQ_PRODUCTS = "      // S = Q K^T and dP = dO V^T, one exact product each\n"
WG_DQ_END = "      for (int c = 0; c < kNC; ++c) fence_acc(acc[c]);\n    }\n    __syncwarp();\n"
WG_CUT_END = "    }\n    __syncwarp();\n"
# the TMA copies of the wgmma bodies, which the "no copies" probes replace
# by a bare arrival (the products then read whatever shared memory holds)
WG_FWD_TILE_COPY = """    mbar_arrive_expect_tx(&full[s], sizeof(bf16) * kStage);
    wg_load_tile<kBK, kDP>(kt, &tk, &full[s], b, h, it * kBK);
    wg_load_tile<kBK, kDP>(kt + kWgTile<kBK, kDP>, &tv, &full[s], b, h, it * kBK);
"""
WG_FWD_Q_COPY = """    mbar_arrive_expect_tx(qbar, sizeof(bf16) * kWgTile<kWgBlockRows, kDP>);
    wg_load_tile<kWgBlockRows, kDP>(qs, &tq, qbar, b, h, q0);
"""
WG_DKV_TILE_COPY = """      mbar_arrive_expect_tx(&full[s], sizeof(bf16) * kStage);
      wg_load_tile<kBQ, kDP>(qt, &tq, &full[s], b, h, q0);
      wg_load_tile<kBQ, kDP>(qt + kWgTile<kBQ, kDP>, &tdo, &full[s], b, h, q0);
"""
WG_DKV_KV_COPY = """      mbar_arrive_expect_tx(kvbar, sizeof(bf16) * 2 * kWgTile<kWgBlockRows, kDP>);
      wg_load_tile<kWgBlockRows, kDP>(ks, &tk, kvbar, b, h, k0);
      wg_load_tile<kWgBlockRows, kDP>(vs, &tv, kvbar, b, h, k0);
"""
WG_DQ_TILE_COPY = """    mbar_arrive_expect_tx(&full[s], sizeof(bf16) * kStage);
    wg_load_tile<kBK, kDP>(kvt, &tk, &full[s], b, h, it * kBK);
    wg_load_tile<kBK, kDP>(kvt + kWgTile<kBK, kDP>, &tv, &full[s], b, h, it * kBK);
"""
WG_DQ_QDO_COPY = """    mbar_arrive_expect_tx(qbar, sizeof(bf16) * 2 * kWgTile<kWgBlockRows, kDP>);
    wg_load_tile<kWgBlockRows, kDP>(qs, &tq, qbar, b, h, q0);
    wg_load_tile<kWgBlockRows, kDP>(dos, &tdo, qbar, b, h, q0);
"""
# dQ's lse and delta rows read by each thread into registers before it
# waits for Q and dO, instead of by cp.async into shared memory tracked by
# that barrier (each consumer thread still arrives on it once)
WG_DQ_ROWS = ("  {\n    const int i = threadIdx.x % kWgBlockRows;\n",
              "    dlt[r] = deltas[row0 + 8 * r - q0];\n  }\n")
WG_DQ_ROWS_IN_REGISTERS = """  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp / 4, qw = q0 + wg * kWgRows;
  const int row0 = qw + (warp % 4) * 16 + g;
  const float scale2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int sr = row0 + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * Sq + min(sr, Sq - 1)) * H + h;
    lse2[r] = sr < Sq ? lse[at] * kLog2e : 0.f;
    dlt[r] = sr < Sq ? delta[at] : 0.f;
  }
  mbar_arrive(qbar);
  float acc[kNC][32];
#pragma unroll
  for (int c = 0; c < kNC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(qbar, 0);
"""
FLASH = "flash_attention.cu"
COMMON = "common.cuh"  # the TF32 split, fragments and mma helpers

# name -> [(source it patches, text in that source, replacement)]
VARIANTS = {
    "fwd_key_tile_64": [(FLASH, "constexpr int kFwdKeyTile = 32;",
                         "constexpr int kFwdKeyTile = 64;")],
    "fwd_min_blocks_2": [(FLASH, "kDP <= 64 ? 4 : 1)", "kDP <= 64 ? 2 : 1)")],
    "dkv_query_tile_32": [(FLASH, "constexpr int kDkvQueryTile = 16;",
                           "constexpr int kDkvQueryTile = 32;")],
    "dkv_query_tile_64": [(FLASH, "constexpr int kDkvQueryTile = 16;",
                           "constexpr int kDkvQueryTile = 64;")],
    "dq_key_tile_16": [(FLASH, "constexpr int kDqKeyTile = 32;", "constexpr int kDqKeyTile = 16;")],
    "dq_a_in_registers": [(FLASH, DQ_ROWS, DQ_ROWS_SPLIT_ONCE),
                          (FLASH, DQ_A_FROM_SMEM, DQ_A_FROM_REGS)],
    "split_by_cvt": [(COMMON, SPLIT_INT, SPLIT_CVT)],
    "probe_no_b_split": [
        (COMMON, B_NK, B_NK.replace("split_in(p[g * ld + t], 1.f, f.big[0], f.small[0]);",
                                    "f.big[0] = f.small[0] = __float_as_uint(p[g * ld + t]);")
         .replace("split_in(p[g * ld + t + 4], 1.f, f.big[1], f.small[1]);",
                  "f.big[1] = f.small[1] = __float_as_uint(p[g * ld + t + 4]);")),
        (COMMON, B_KN, B_KN.replace("split_in(p[2 * t * ld + g], 1.f, f.big[0], f.small[0]);",
                                    "f.big[0] = f.small[0] = __float_as_uint(p[2 * t * ld + g]);")
         .replace("split_in(p[(2 * t + 1) * ld + g], 1.f, f.big[1], f.small[1]);",
                  "f.big[1] = f.small[1] = __float_as_uint(p[(2 * t + 1) * ld + g]);")),
    ],
    "probe_one_tf32": [(COMMON, "  if constexpr (!kExactB) mma_tf32(c, a.big, b.small);\n"
                                "  if constexpr (!kExactA) mma_tf32(c, a.small, b.big);\n", "")],
    # the bf16 wgmma bodies
    "wg_stages_3": [(FLASH, "constexpr int kWgStages = 2;", "constexpr int kWgStages = 3;")],
    "wg_stages_4": [(FLASH, "constexpr int kWgStages = 2;", "constexpr int kWgStages = 4;")],
    "wg_fwd_key_tile_128": [(FLASH, "constexpr int kWgFwdKeys = 64;",
                             "constexpr int kWgFwdKeys = 128;")],
    "wg_dkv_query_tile_128": [(FLASH, "constexpr int kWgDkvQueries = 64;",
                               "constexpr int kWgDkvQueries = 128;")],
    "wg_groups_2": [(FLASH, "constexpr int kWgGroups = 1;", "constexpr int kWgGroups = 2;")],
    "wg_fwd_min_blocks_5": [(FLASH, "constexpr int kWgFwdMinBlocks = 4;",
                             "constexpr int kWgFwdMinBlocks = 5;")],
    "wg_dkv_min_blocks_2": [(FLASH, "constexpr int kWgDkvMinBlocks = 3;",
                             "constexpr int kWgDkvMinBlocks = 2;")],
    "wg_dq_min_blocks_3": [(FLASH, "constexpr int kWgDqMinBlocks = 4;",
                            "constexpr int kWgDqMinBlocks = 3;")],
    "wg_dq_key_tile_128": [(FLASH, "constexpr int kWgDqKeys = 64;",
                            "constexpr int kWgDqKeys = 128;")],
    "wg_dq_rows_in_registers": [(FLASH, WG_DQ_ROWS, WG_DQ_ROWS_IN_REGISTERS)],
    "wg_l2_promotion_256": [(FLASH, "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                             "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "wg_prefetch_maps": [
        (FLASH, "  if (threadIdx.x == 0) {\n    mbar_init(qbar, 1);",
         "  if (threadIdx.x == 0) {\n"
         "    for (const CUtensorMap* m : {&tq, &tk, &tv})\n"
         "      asm volatile(\"prefetch.tensormap [%0];\" ::\"l\"(reinterpret_cast<uint64_t>(m)) : \"memory\");\n"
         "    mbar_init(qbar, 1);"),
        (FLASH, "  if (threadIdx.x == 0) {\n    mbar_init(kvbar, 1);",
         "  if (threadIdx.x == 0) {\n"
         "    for (const CUtensorMap* m : {&tq, &tk, &tv, &tdo})\n"
         "      asm volatile(\"prefetch.tensormap [%0];\" ::\"l\"(reinterpret_cast<uint64_t>(m)) : \"memory\");\n"
         "    mbar_init(kvbar, 1);")],
    "wg_producer_warp": [(FLASH, "constexpr bool kWgProducerWarp = false;",
                          "constexpr bool kWgProducerWarp = true;")],
    "wg_exp2f": [(COMMON, '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                  "  y = exp2f(x);")],
    "wg_carveout_max": [
        (FLASH, "    rc = prepare(flash_fwd_wg_kernel<kDP>, smem, &ready[0]);",
         "    cudaFuncSetAttribute(flash_fwd_wg_kernel<kDP>,\n"
         "                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
         "    rc = prepare(flash_fwd_wg_kernel<kDP>, smem, &ready[0]);"),
        (FLASH, "    rc = prepare(flash_bwd_dkv_wg_kernel<kDP>, smem, &ready[2]);",
         "    cudaFuncSetAttribute(flash_bwd_dkv_wg_kernel<kDP>,\n"
         "                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
         "    rc = prepare(flash_bwd_dkv_wg_kernel<kDP>, smem, &ready[2]);"),
        (FLASH, "    rc = prepare(flash_bwd_dq_wg_kernel<kDP>, smem, &ready[1]);",
         "    cudaFuncSetAttribute(flash_bwd_dq_wg_kernel<kDP>,\n"
         "                         cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
         "    rc = prepare(flash_bwd_dq_wg_kernel<kDP>, smem, &ready[1]);")],
    # parts of the wgmma bodies left out (wrong results: what each part costs)
    "wg_probe_fwd_copies_only": [(FLASH, (WG_FWD_PRODUCTS, WG_FWD_END), WG_CUT_END)],
    "wg_probe_fwd_no_pv": [(FLASH, (WG_FWD_PV, WG_FWD_END), WG_CUT_END)],
    "wg_probe_fwd_pv_hi_only": [(FLASH, WG_FWD_PV_LO, "")],
    "wg_probe_dkv_copies_only": [(FLASH, (WG_DKV_PRODUCTS, WG_DKV_END), WG_CUT_END)],
    "wg_probe_dkv_no_rs": [(FLASH, (WG_DKV_RS, WG_DKV_END), WG_CUT_END)],
    "wg_probe_fwd_no_copies": [(FLASH, WG_FWD_TILE_COPY, "    mbar_arrive(&full[s]);\n"),
                               (FLASH, WG_FWD_Q_COPY, "    mbar_arrive(qbar);\n")],
    "wg_probe_dkv_no_copies": [(FLASH, WG_DKV_TILE_COPY, "      mbar_arrive(&full[s]);\n"),
                               (FLASH, WG_DKV_KV_COPY, "      mbar_arrive(kvbar);\n")],
    "wg_probe_dkv_rs_hi_only": [(FLASH, WG_DKV_RS_LO, WG_DKV_RS_LO.splitlines(True)[1])],
    "wg_probe_dq_copies_only": [(FLASH, (WG_DQ_PRODUCTS, WG_DQ_END), WG_CUT_END)],
    "wg_probe_dq_no_copies": [(FLASH, WG_DQ_TILE_COPY, "    mbar_arrive(&full[s]);\n"),
                              (FLASH, WG_DQ_QDO_COPY, "    mbar_arrive(qbar);\n")],
}

WGMMA_PEAK_CU = r"""
#include "common.cuh"
// kIters batches of 16 dependent wgmma m64n64k16 into one accumulator a
// warpgroup, operands from a zero-padded 128-byte-swizzled tile
template <bool kRs>
__global__ void wgmma_loop(float* out, int iters) {
  __shared__ __align__(16) unsigned char raw[2 * 8192 + 1024];
  bf16* tile = reinterpret_cast<bf16*>(raw + ((1024u - (smem_addr(raw) & 1023u)) & 1023u));
  for (int i = threadIdx.x; i < 2 * 64 * 64; i += blockDim.x)
    tile[i] = __float2bfloat16_rn(1e-3f * (i % 7));
  __syncthreads();
  float acc[32];
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = 0x3c003c00u + threadIdx.x + i;
  const uint64_t da = gmma_desc(tile, 16, 1024), db = gmma_desc(tile + 64 * 64, 16, 1024);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (kRs) wgmma_rs(acc, a, db); else wgmma_ss(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
  }
  float s = 0.f;
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of one launch of blocks x (128 x warpgroups) threads, after a warm-up launch
extern "C" float ff_wgmma_peak_ms(int blocks, int warpgroups, int iters, int rs) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * 128 * warpgroups);
  auto launch = [&] {
    if (rs) wgmma_loop<true><<<blocks, 128 * warpgroups>>>(out, iters);
    else wgmma_loop<false><<<blocks, 128 * warpgroups>>>(out, iters);
  };
  launch();
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  launch();
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, s, e);
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""

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


def variant_sources(main: str, variants) -> dict:
    """{name: {file: text}}: the checkout's ``csrc/<main>`` and the
    ``common.cuh`` it includes as ``"source"``, and a copy of both per
    variant with each (file, old, new) substitution made in the file it
    names; an ``old`` of two texts replaces everything from the first
    through the next occurrence of the second. Raises where a text is not in its source, so a
    variant cannot silently patch nothing."""
    from flexflow_tpu_torch.ops.kernels import _build

    base = {main: (_build.CSRC_DIR / main).read_text(),
            COMMON: (_build.CSRC_DIR / COMMON).read_text()}
    out = {"source": dict(base)}
    for name, subs in variants.items():
        files = dict(base)
        for file, old, new in subs:
            text = files[file]
            if isinstance(old, tuple):
                start = text.find(old[0])
                if start < 0 or old[1] not in text[start:]:
                    raise RuntimeError(f"{name}: {old[0][:60]!r} ... is not in {file}")
                end = text.index(old[1], start) + len(old[1])
                files[file] = text[:start] + new + text[end:]
                continue
            if old not in text:
                raise RuntimeError(f"{name}: {old[:60]!r} is not in {file}")
            files[file] = text.replace(old, new)
        out[name] = files
    return out


def _compile(named_sources):
    """{name: (.so path, nvcc's log)} for {name: {file name: text}} (the
    one ``.cu`` among the files is compiled; the headers it includes are
    read beside it), one nvcc each, in parallel. A plain text is one
    ``.cu`` file of its own."""
    from flexflow_tpu_torch.ops.kernels import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the probes build CUDA code")
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, files in named_sources.items():
        if isinstance(files, str):
            files = {f"{name}.cu": files}
        var_dir = out_dir / name
        var_dir.mkdir(exist_ok=True)
        for file, text in files.items():
            (var_dir / file).write_text(text)
        src, = (var_dir / f for f in files if f.endswith(".cu"))
        so = out_dir / f"{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)]
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


def variants(names=()) -> int:
    import torch

    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 2
    libs = {}
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"no such variants: {unknown}")
    chosen = {n: VARIANTS[n] for n in (names or VARIANTS)}
    for name, (so, log) in _compile(variant_sources(FLASH, chosen)).items():
        lib = ctypes.CDLL(str(so))
        for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
            for form in ("f32", "bf16"):
                fn = getattr(lib, f"ff_flash_{kernel}_{form}")
                fn.argtypes = _build.SIGNATURES[f"ff_flash_{kernel}_{form}"]
                fn.restype = ctypes.c_int
        libs[name] = lib
        lib.ff_flash_wg_blocks_per_sm.argtypes = _build.SIGNATURES["ff_flash_wg_blocks_per_sm"]
        print(f"{name}: blocks an SM of the bf16 wgmma fwd<64> "
              f"{lib.ff_flash_wg_blocks_per_sm(0, 64)}, dq<64> "
              f"{lib.ff_flash_wg_blocks_per_sm(1, 64)}, dkv<64> "
              f"{lib.ff_flash_wg_blocks_per_sm(2, 64)}; "
              f"registers fwd<64> {_registers(log, 'flash_fwd_tc_kernelILi64EfE')}, "
              f"dq<64> {_registers(log, 'flash_bwd_dq_tc_kernelILi64EfE')}, "
              f"dkv<64> {_registers(log, 'flash_bwd_dkv_tc_kernelILi64EfE')}; bf16 wgmma "
              f"fwd<64> {_registers(log, 'flash_fwd_wg_kernelILi64EE')}, "
              f"dq<64> {_registers(log, 'flash_bwd_dq_wg_kernelILi64EE')}, "
              f"dkv<64> {_registers(log, 'flash_bwd_dkv_wg_kernelILi64EE')}")

    def form_of(q):
        return "bf16" if q.dtype == torch.bfloat16 else "f32"

    def run_fwd(lib, q, k, v, causal, scale):
        b, sq, h, d = q.shape
        o, lse = torch.empty_like(q), torch.empty(b, sq, h, device=q.device)
        rc = getattr(lib, f"ff_flash_fwd_{form_of(q)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, sq,
            k.shape[1], h, d, scale, int(causal), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"forward launch failed: {rc}")
        return o

    def run_dq(lib, q, k, v, do, lse, delta, causal, scale):
        b, sq, h, d = q.shape
        dq = torch.empty_like(q)
        rc = getattr(lib, f"ff_flash_bwd_dq_{form_of(q)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, sq, k.shape[1], h, d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dQ launch failed: {rc}")
        return dq

    def run_dkv(lib, q, k, v, do, lse, delta, causal, scale):
        b, sq, h, d = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = getattr(lib, f"ff_flash_bwd_dkv_{form_of(q)}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, k.shape[1], h, d, scale,
            int(causal), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dK/dV launch failed: {rc}")
        return dk, dv

    def graph_ms(fn, sets, iters=16, reps=5):
        """Device ms a call: ``iters`` calls cycling over ``sets`` captured
        in one CUDA graph and replayed ``reps`` times between CUDA events,
        free of the host's launch rate (the wgmma bodies encode their tensor
        maps on the host at each call)."""
        for st in sets:
            fn(*st)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(*sets[i % len(sets)])
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (reps * iters)

    print(_card())
    for (b, s, h, d, causal), dtype in itertools.product(
            [(32, 128, 12, 64, False), (4, 512, 12, 64, True)], (torch.float32, torch.bfloat16)):
        gen = torch.Generator().manual_seed(1)
        scale = d ** -0.5
        sets = []  # 3 copies of the inputs, together past the 50 MB L2
        for _ in range(3):
            q, k, v, do = (torch.randn(b, s, h, d, generator=gen).cuda().to(dtype)
                           for _ in range(4))
            po, plse = fa.reference_flash_forward(q, k, v, causal, scale)
            sets.append((q, k, v, do, plse, fa.flash_delta(do, po)))
        q, k, v, do, plse, delta = sets[0]
        po, _ = fa.reference_flash_forward(q, k, v, causal, scale)
        bwd = (q, k, v, do, plse, delta, causal, scale)
        pdq, pdk, pdv = fa.reference_flash_backward(*bwd)
        times = {name: [] for name in libs}
        for order in (list(libs), list(reversed(list(libs)))):
            for name in order:
                lib = libs[name]
                times[name].append((
                    graph_ms(lambda q, k, v, *_: run_fwd(lib, q, k, v, causal, scale), sets),
                    graph_ms(lambda *a: run_dq(lib, *a, causal, scale), sets),
                    graph_ms(lambda *a: run_dkv(lib, *a, causal, scale), sets)))
        for name, lib in libs.items():
            o = run_fwd(lib, q, k, v, causal, scale)
            dq = run_dq(lib, *bwd)
            dk, dv = run_dkv(lib, *bwd)
            err = max(float((got.float() - want.float()).abs().max())
                      for got, want in ((o, po), (dq, pdq), (dk, pdk), (dv, pdv)))
            print(f"B={b} S={s} causal={causal} {form_of(q)} {name:22s} ms "
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


def wgmma_peak() -> int:
    import torch

    from flexflow_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sources = {"wgmma_peak.cu": WGMMA_PEAK_CU,
               COMMON: (_build.CSRC_DIR / COMMON).read_text()}
    (so, _), = _compile({"wgmma_peak": sources}).values()
    lib = ctypes.CDLL(str(so))
    lib.ff_wgmma_peak_ms.restype = ctypes.c_float
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(_card())
    for rs, warpgroups in itertools.product((0, 1), (1, 2)):
        blocks, iters = 4 * sms, 4000
        ms = lib.ff_wgmma_peak_ms(blocks, warpgroups, iters, rs)
        if ms <= 0:
            raise RuntimeError("the wgmma peak kernel failed to launch")
        flops = blocks * warpgroups * iters * 16 * (64 * 64 * 16 * 2)
        print(f"{warpgroups} warpgroup(s) a block, {blocks} blocks, A from "
              f"{'registers' if rs else 'shared memory'}: {flops / ms / 1e9:.1f} TFLOP/s "
              f"(wgmma m64n64k16 bf16, {ms:.3f} ms)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", choices=["variants", "mma-peak", "wgmma-peak"])
    ap.add_argument("names", nargs="*", help="variants: the variants to build (default: all)")
    args = ap.parse_args(argv)
    if args.probe == "variants":
        return variants(args.names)
    return mma_peak() if args.probe == "mma-peak" else wgmma_peak()


if __name__ == "__main__":
    sys.exit(main())
