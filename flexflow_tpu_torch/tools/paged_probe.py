"""Probes of the paged attention kernels' design on one NVIDIA GPU.

    python3 -m flexflow_tpu_torch.tools.paged_probe [--kv-dtype float32|bfloat16|float16]

Builds copies of ``ops/kernels/csrc/paged_attention.cu`` with one design
choice changed each (a text substitution: :data:`VARIANTS` for the
single-pass kernel, :data:`SPLIT_VARIANTS` for the split-KV
kernel), all nvcc runs at once, and times each at the
serving path's shapes (H=12, D=64, 64 table columns of 16): the
single-pass kernel at decode B=4 W=1 (contexts 731/18/0/377) and append
W=5; the split-KV kernel at B=1 W=1, context 931 (the long-context
cell's) with S=8, 16 and 64 (= MB) splits, and context 300 with S=8.
Device ms per call from a CUDA graph of 16 calls over 8 copies of the
cache (past the L2), replayed 5 times between CUDA events, in two rounds
(forward order, then reverse). Each variant is held against the plain
version; the ``probe`` variants give wrong results on purpose (they
measure what a part of the kernel costs). The split cases also time the
single-pass kernel on the same inputs (its cluster of 8 = S at the
long-context shape, sharing the live positions). It also prints how many
clusters of the decode launch the card can hold at once
(``cudaOccupancyMaxActiveClusters``). ``--kv-dtype`` picks the cache
form the cases run (the kernels' ``_f32``, ``_bf16`` or ``_f16``
symbols over caches of that dtype; q stays float32).

Builds land in ``ops/kernels/_build/probe/``; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import sys

from flexflow_tpu_torch.tools.flash_probe import VARIANTS as VARIANTS_OF_FLASH
from flexflow_tpu_torch.tools.flash_probe import _card, _compile, variant_sources

PAGED = "paged_attention.cu"

# single-pass variants: name -> [(source it patches, text in it, replacement)]
VARIANTS = {
    # rounds of two tiles, or of one (no copies in flight beside it)
    "two_tile_rounds": [(PAGED, "  int stages = kMaxStages;\n", "  int stages = 2;\n")],
    "one_tile_rounds": [(PAGED, "  int stages = kMaxStages;\n", "  int stages = 1;\n")],
    # each CTA of the cluster takes a fixed share of the table's columns
    "column_shares": [(PAGED, "    const int share = ((live + S - 1) / S + kTile - 1) / kTile * kTile;\n"
                       "    pos0 = s * share;\n"
                       "    pos1 = min(live, pos0 + share);\n",
                       "    const int cols = (MB + S - 1) / S;\n"
                       "    pos0 = s * cols * bs;\n"
                       "    pos1 = min(min(MB, (s + 1) * cols) * bs, live);\n")],
    # fp32 rows padded to 16 mod 32 floats (no bank conflicts in the score
    # reads); 2-byte rows padded by 8 elements (4 banks) instead of 16
    "rows_16_mod_32": [(PAGED, "sizeof(T) == 4 ? round4(d) + 4 :",
                        "sizeof(T) == 4 ? (round4(d) + 47) / 32 * 32 - 16 :")],
    "two_byte_rows_plus_8": [(PAGED, "((d + 7) & ~7) + 16;", "((d + 7) & ~7) + 8;")],
    "cta_positions_256": [(PAGED, "constexpr int kCtaPositions = 128;",
                           "constexpr int kCtaPositions = 256;")],
    "probe_no_compute": [(PAGED, "    // scores of position quad_t of every tile with every query\n",
                          "    continue;  // probe\n")],
    "probe_no_combine": [(PAGED, "  cluster.sync();  // every CTA's m, l and acc are written and visible\n",
                          "  if (tid >= 0) return;  // probe\n")],
    "probe_launch_only": [(PAGED, "  // the table columns this CTA holds: from its range's first, or from the row's first\n",
                           "  cg::this_cluster().sync();\n"
                           "  if (tid >= 0) return;  // probe\n")],
}

SPLIT_PROBES = ("probe_no_compute", "probe_no_combine", "probe_launch_only")

_COMBINE_START = "  // combine the cluster's CTAs exactly, through distributed shared memory\n"
_COMBINE_END = "  cluster.sync();  // no CTA exits while another still reads its shared memory\n"
_KERNEL = "// T: the cache's element type"

# (b): no cluster; each CTA writes its partials to a global scratch, and
# the last CTA of a (head, sequence) to arrive (an atomic ticket after a
# __threadfence) combines them and resets the ticket. The scratch is
# static and sized for the probe's shapes (B * H * CTAs * W * D <= 2^16).
_TICKET_GLOBALS = """__device__ float g_probe_acc[1 << 16];
__device__ float g_probe_m[1 << 12];
__device__ float g_probe_l[1 << 12];
__device__ unsigned g_probe_ticket[1 << 10];

"""
_TICKET_COMBINE = """  {
    // the ticket's answer in the tiles' memory (free after the loop): a
    // static __shared__ word beside the full dynamic request is refused
    unsigned& last_s = *reinterpret_cast<unsigned*>(tiles);
    const long long bh = static_cast<long long>(b) * gridDim.y + h;
    float* pa = g_probe_acc + (bh * S + s) * W * D;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < W * D) pa[idx] = acc[k];
    }
    for (int w = tid; w < W; w += kThreads) {
      g_probe_m[(bh * S + s) * W + w] = m_s[w];
      g_probe_l[(bh * S + s) * W + w] = l_s[w];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(g_probe_ticket + bh, 1u) == static_cast<unsigned>(S - 1);
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int idx = tid; idx < W * D; idx += kThreads) {
      const int w = idx / D, d = idx - w * D;
      float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const long long i = bh * S + r;
        mr[r] = r < S ? __ldcg(g_probe_m + i * W + w) : kNegInf;
        lr[r] = r < S ? __ldcg(g_probe_l + i * W + w) : 0.f;
        ar[r] = r < S ? __ldcg(g_probe_acc + i * W * D + idx) : 0.f;
      }
      float mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (lr[r] > 0.f) mx = fmaxf(mx, mr[r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        const float a = lr[r] > 0.f ? expf(mr[r] - mx) : 0.f;
        num = fmaf(ar[r], a, num);
        den = fmaf(lr[r], a, den);
      }
      out[(static_cast<long long>(b) * W + w) * HD + static_cast<long long>(h) * D + d] =
          qp_s[w] >= 0 ? num / fmaxf(den, 1e-30f) : 0.f;
    }
    if (tid == 0) g_probe_ticket[bh] = 0;
  }
"""


# (push): each CTA writes its m, l and accumulator into a receive area of
# rank 0's shared memory, arrives at the cluster barrier and exits; rank 0
# alone waits and combines, so the combine costs one barrier, not two. A
# barrier phase at the kernel's start (arrive at once, wait before the
# remote writes) makes sure every CTA of the cluster has started. Each
# CTA's record holds the layout's Wl queries; the tile's Wt are written.
_PUSH_COMBINE = """  cg::cluster_group cluster = cg::this_cluster();
  const int rec = 2 * Wl + Wl * D;
  float* recv_s = reinterpret_cast<float*>(bt_s + bt_held);  // rank 0: [S][m, l, acc]
  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");
  float* dst = cluster.map_shared_rank(recv_s, 0) + s * rec;
  for (int w = tid; w < Wt; w += kThreads) {
    dst[w] = m_s[w];
    dst[Wl + w] = l_s[w];
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < Wt * D) dst[2 * Wl + idx] = acc[k];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
  if (s != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
  for (int idx = tid; idx < Wt * D; idx += kThreads) {
    const int w = idx / D, d = idx - w * D;
    float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = r < S ? recv_s[r * rec + w] : kNegInf;
      lr[r] = r < S ? recv_s[r * rec + Wl + w] : 0.f;
      ar[r] = r < S ? recv_s[r * rec + 2 * Wl + idx] : 0.f;
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (lr[r] > 0.f) mx = fmaxf(mx, mr[r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      const float a = lr[r] > 0.f ? expf(mr[r] - mx) : 0.f;
      num = fmaf(ar[r], a, num);
      den = fmaf(lr[r], a, den);
    }
    out[(static_cast<long long>(b) * W + w0 + w) * HD + static_cast<long long>(h) * D + d] =
        qp_s[w] >= 0 ? num / fmaxf(den, 1e-30f) : 0.f;
  }
"""

# split-KV variants; the probe_* variants above (SPLIT_PROBES) time the
# split launch's parts as well
SPLIT_VARIANTS = {
    # (a16) a non-portable cluster of up to 16 CTAs, one per split up to 16
    "cluster16": [(PAGED, "constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
                  (PAGED, "    if (e != cudaSuccess) return static_cast<int>(e);\n    ready = true;\n",
                   "    if (e != cudaSuccess) return static_cast<int>(e);\n"
                   "    cudaFuncSetAttribute(paged_append_kernel<T, kMaxW, kSplit, kMaxD>,\n"
                   "                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                   "    ready = true;\n")],
    # rounds of at most 3 tiles (a quarter of an SM's shared memory, as
    # the single-pass form): a 128-position range takes two rounds
    "split_stages3": [(PAGED, "kSmemLimit / (kSplit ? 2 : 4)", "kSmemLimit / 4")],
    # (b) partials in a global scratch, the last CTA to arrive combines
    "ticket": [(PAGED, (_COMBINE_START, _COMBINE_END), _TICKET_COMBINE),
               (PAGED, _KERNEL, _TICKET_GLOBALS + _KERNEL),
               (PAGED, "  cfg.numAttrs = 1;\n", "  cfg.numAttrs = C > 0 ? 1 : 0;\n"),
               (PAGED, "dim3(C, H, B * ((W + kMaxW - 1) / kMaxW)), C, smem",
                "dim3(C, H, B * ((W + kMaxW - 1) / kMaxW)), kSplit ? 0 : C, smem")],
    # the combine pushed into rank 0's shared memory (one barrier)
    "push": [(PAGED, (_COMBINE_START, _COMBINE_END), _PUSH_COMBINE),
             (PAGED, "  int* bt_s = qp_s + Wl;", "  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\" ::: "
              "\"memory\");\n  int* bt_s = qp_s + Wl;"),
             (PAGED, "static_cast<size_t>(bt_held));",
              "static_cast<size_t>(bt_held) + kMaxCluster * (2 * w + w * D));")],
}


OCCUPANCY_CU = r"""
template <typename T>
int max_active_clusters(int W, int D, int MB, int bs, int H, int B) {
  const int c = cluster_size(MB, bs);
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes<T>(W, D, MB, stages) > kSmemLimit / 4) --stages;
  cudaFuncSetAttribute(paged_append_kernel<T, 1, false, 256>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemLimit));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<T>(W, D, MB, stages);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, paged_append_kernel<T, 1, false, 256>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// the decode launch's clusters the card holds at once, by cache element
// size (4: fp32, 2: bf16; fp16 takes bf16's shared memory)
extern "C" int ff_probe_max_active_clusters(int W, int D, int MB, int bs, int H, int B,
                                            int kv_bytes) {
  return kv_bytes == 4 ? max_active_clusters<float>(W, D, MB, bs, H, B)
                       : max_active_clusters<bf16>(W, D, MB, bs, H, B);
}
"""


def _inputs(torch, gen, ctx_lens, w, copies, kv_dtype, nb=257, bs=16, h=12, d=64, mb=64,
            real=None):
    """``copies`` sets of (q, k, v, tables, positions) of the kernel phase
    of chip_smoke.py, caches of ``kv_dtype``: tables over a random
    permutation of the blocks, window ``w`` starting at each context's last
    position (a context of 0 is a padding-only slot), queries past the
    first ``real`` of each window padding."""
    import numpy as np

    rs = np.random.RandomState(0)
    perm = rs.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((len(ctx_lens), mb), np.int32)
    used = 0
    for i, n in enumerate(ctx_lens):
        nblk = -(-(n + w - 1) // bs)
        tables[i, :nblk] = perm[used:used + nblk]
        used += nblk
    qpos = np.asarray(ctx_lens)[:, None] - 1 + np.arange(w)[None, :]
    qpos[np.asarray(ctx_lens) == 0] = -1
    if real is not None:
        qpos[:, real:] = -1
    dev = torch.device("cuda")
    bt = torch.from_numpy(tables).to(dev)
    qp = torch.from_numpy(qpos.astype(np.int32)).to(dev)
    return [(torch.randn((len(ctx_lens), w, h, d), generator=gen).to(dev),
             torch.randn((nb, bs, h, d), generator=gen).to(dev, kv_dtype),
             torch.randn((nb, bs, h, d), generator=gen).to(dev, kv_dtype), bt, qp)
            for _ in range(copies)]


def _load(so):
    """The paged library at ``so`` with every form's argument types set."""
    from flexflow_tpu_torch.ops.kernels import _build

    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("ff_paged_append_") and hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _single(torch, lib, form):
    """A call of ``lib``'s single-pass kernel of cache form ``form``."""
    def run(q, k, v, bt, qp):
        b, w, h, d = q.shape
        out = torch.empty_like(q)
        rc = getattr(lib, f"ff_paged_append_{form}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(), qp.data_ptr(),
            out.data_ptr(), b, w, h, d, k.shape[1], bt.shape[1], d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return out
    return run


def _split(torch, lib, form, s, max_ctas=None):
    """A call of ``lib``'s split-KV kernel of form ``form`` over ``s`` splits."""
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    def run(q, k, v, bt, qp):
        b, w, h, d = q.shape
        ctas, cols = da.split_plan(s, bt.shape[1], max_ctas or da.MAX_CLUSTER)
        out = torch.empty_like(q)
        rc = getattr(lib, f"ff_paged_append_split_{form}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(), qp.data_ptr(),
            out.data_ptr(), b, w, h, d, k.shape[1], bt.shape[1], ctas, cols, d ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return out
    return run


# the wide-window body's variants: name -> [(source it patches, text, replacement)]
WINDOW_VARIANTS = {
    # every window on the CUDA-core body (the crossover's other side)
    "cuda_cores": [(PAGED, "constexpr int kTcMinWindow = 9;",
                    "constexpr int kTcMinWindow = 1 << 30;")],
    # key tiles of 32 positions (less shared memory: more CTAs an SM)
    "tc_keys_32": [(PAGED, "constexpr int kTcKeys = 64;", "constexpr int kTcKeys = 32;")],
    # the query tiles launched first to last (the first see the fewest
    # positions of a causal window)
    "tc_tiles_in_order": [(PAGED, "  const int w0 = (q_tiles - 1 - (blockIdx.z - b * q_tiles)) * kTcQueries;",
                           "  const int w0 = (blockIdx.z - b * q_tiles) * kTcQueries;")],
    # the single-pass launch aims at 4 CTAs an SM (its cluster size)
    "tc_ctas_per_sm_4": [(PAGED, "constexpr int kTcCtasPerSm = 2;",
                          "constexpr int kTcCtasPerSm = 4;")],
    # probes of the tensor-core body's parts (wrong results on purpose):
    # the copies alone, the products without the copies, without P V, and
    # without the split of K and V (an fp32 cache's B fragments: the flash
    # probe's substitution in common.cuh)
    "probe_tc_copies_only": [(PAGED, "    if (k0 <= warp_qp) {  // else no row of this warp sees the tile",
                              "    if (k0 <= warp_qp && tid < 0) {  // probe")],
    "probe_tc_no_copies": [(PAGED, "  auto stage = [&](int k0, int buf) {\n",
                            "  auto stage = [&](int k0, int buf) {\n    if (tid >= 0) return;  // probe\n")],
    "probe_tc_no_pv": [(PAGED, "      for (int j = 0; j < kKT; ++j) {\n        FragA a;\n        acc_to_a(a, sc[j]);",
                        "      for (int j = 0; j < (tid < 0 ? kKT : 0); ++j) {  // probe\n        FragA a;\n"
                        "        acc_to_a(a, sc[j]);")],
    "probe_tc_no_b_split": VARIANTS_OF_FLASH["probe_no_b_split"],
}


def windows() -> int:
    """The crossover and the tensor-core body's design at the serving
    shapes (H=12, D=64, 64 columns of 16): one sequence's suffix window
    of W queries from position 512 (from 0 at W = 1024) and a 4-slot
    verify-like batch (contexts 700/40/0/300), single-pass in every build
    of WINDOW_VARIANTS and split (S=8) in the checkout's and the
    CUDA-core build, for each cache form; two rounds (forward order,
    then reverse)."""
    import torch

    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    libs = {name: _load(so) for name, (so, _) in
            _compile(variant_sources(PAGED, WINDOW_VARIANTS)).items()}
    print(_card())
    gen = torch.Generator().manual_seed(0)
    for kv_dtype, (form, _) in da._FORMS.items():
        # (case, contexts, window, real queries a window, every build timed)
        cases = [(f"B=1 W={w}", [1 if w > 512 else 513], w, None, w in (64, 256, 1024))
                 for w in (9, 16, 32, 33, 40, 64, 256, 1024)]
        cases += [(f"B=4 W={w}", [700, 40, 0, 300], w, None, w == 40) for w in (9, 40)]
        # the chip_smoke kernel phase's W = 1024 case: 854 real queries from 0
        cases += [("B=1 W=1024 854 real", [1], 1024, 854, True)]
        for case, ctx, w, real, every in cases:
            sets = _inputs(torch, gen, ctx, w, copies=8, kv_dtype=kv_dtype, real=real)
            want = da.reference_paged_append_attention(*sets[0])
            runs = {name: _single(torch, lib, form) for name, lib in libs.items()
                    if every or name in ("source", "cuda_cores")}
            if w <= 64:
                runs.update({f"{name} split S=8": _split(torch, libs[name], form, 8)
                             for name in ("source", "cuda_cores")})
            times = {name: [] for name in runs}
            for order in (list(runs), list(reversed(list(runs)))):
                for name in order:
                    times[name].append(_graph_ms(torch, runs[name], sets))
            for name, fn in runs.items():
                err = float((fn(*sets[0]) - want).abs().max())
                print(f"{form:4s} {case:10s} {name:24s} ms "
                      + " ".join(f"{t:.5f}" for t in times[name]) + f"  max abs err {err:.2e}")
            del sets
    return 0


def _graph_ms(torch, fn, sets, iters=16, reps=5):
    for a in sets[:2]:
        fn(*a)
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


def main(argv=None) -> int:
    import argparse

    import torch

    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kv-dtype", choices=("float32", "bfloat16", "float16"), default="float32",
                    help="the KV cache's dtype: which form of the kernels the cases time")
    ap.add_argument("--windows", action="store_true",
                    help="time the two bodies and the tensor-core body's variants at wide "
                         "windows, every cache form (WINDOW_VARIANTS)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device is available", file=sys.stderr)
        return 2
    if args.windows:
        return windows()
    kv_dtype = getattr(torch, args.kv_dtype)
    form = da._FORMS[kv_dtype][0]
    sources = variant_sources(PAGED, {**VARIANTS, **SPLIT_VARIANTS})
    sources["source"][PAGED] += OCCUPANCY_CU
    libs = {name: _load(so) for name, (so, _) in _compile(sources).items()}
    print(_card())
    clusters = libs["source"].ff_probe_max_active_clusters(1, 64, 64, 16, 12, 4,
                                                          kv_dtype.itemsize)
    print(f"{args.kv_dtype} cache, decode launch (W=1, D=64, 64 columns of 16, H=12, B=4): "
          f"the card holds {clusters} clusters at once")

    def single(lib):
        return _single(torch, lib, form)

    def split(lib, s, max_ctas=None):
        return _split(torch, lib, form, s, max_ctas)

    single_runs = {name: single(libs[name]) for name in ["source", *VARIANTS]}

    def split_runs(s):
        runs = {"(a) source": split(libs["source"], s),
                "(a16) cluster16": split(libs["cluster16"], s, 16),
                "(b) ticket": split(libs["ticket"], s),
                "push": split(libs["push"], s),
                "split_stages3": split(libs["split_stages3"], s)}
        runs.update({name: split(libs[name], s) for name in SPLIT_PROBES})
        runs["(c) single-pass"] = single(libs["source"])
        return runs

    gen = torch.Generator().manual_seed(0)
    cases = {"decode B=4 W=1": ([731, 18, 0, 377], 1, single_runs),
             "append B=4 W=5": ([700, 40, 0, 300], 5, single_runs),
             "split B=1 S=8 ctx 931": ([931], 1, split_runs(8)),
             "split B=1 S=16 ctx 931": ([931], 1, split_runs(16)),
             "split B=1 S=64 ctx 931": ([931], 1, split_runs(64)),
             "split B=1 S=8 ctx 300": ([300], 1, split_runs(8))}
    for case, (ctx, w, runs) in cases.items():
        sets = _inputs(torch, gen, ctx, w, copies=8, kv_dtype=kv_dtype)
        want = da.reference_paged_append_attention(*sets[0])
        times = {name: [] for name in runs}
        for order in (list(runs), list(reversed(list(runs)))):
            for name in order:
                try:
                    times[name].append(_graph_ms(torch, runs[name], sets))
                except RuntimeError as e:  # a variant the card refuses is reported, not fatal
                    times[name].append(str(e))
                    torch.cuda.synchronize()
        for name, fn in runs.items():
            if any(isinstance(t, str) for t in times[name]):
                print(f"{case:24s} {name:20s} {times[name][0]}")
                continue
            err = float((fn(*sets[0]) - want).abs().max())
            print(f"{case:24s} {name:20s} ms " + " ".join(f"{t:.4f}" for t in times[name])
                  + f"  max abs err {err:.2e}")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
