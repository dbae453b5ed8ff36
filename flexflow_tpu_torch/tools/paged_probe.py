"""Probes of the paged attention kernels' design on one NVIDIA GPU.

    python3 -m flexflow_tpu_torch.tools.paged_probe

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
(``cudaOccupancyMaxActiveClusters``).

Builds land in ``ops/kernels/_build/probe/``; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import sys

from flexflow_tpu_torch.tools.flash_probe import _card, _compile

# single-pass variants: name -> [(text in the source, replacement)]
VARIANTS = {
    # rounds of two tiles, or of one (no copies in flight beside it)
    "two_tile_rounds": [("  int stages = kMaxStages;\n", "  int stages = 2;\n")],
    "one_tile_rounds": [("  int stages = kMaxStages;\n", "  int stages = 1;\n")],
    # each CTA of the cluster takes a fixed share of the table's columns
    "column_shares": [("    const int share = ((live + S - 1) / S + kTile - 1) / kTile * kTile;\n"
                       "    pos0 = s * share;\n"
                       "    pos1 = min(live, pos0 + share);\n",
                       "    const int cols = (MB + S - 1) / S;\n"
                       "    pos0 = s * cols * bs;\n"
                       "    pos1 = min(min(MB, (s + 1) * cols) * bs, live);\n")],
    # rows padded to 16 mod 32 floats (no bank conflicts in the score reads)
    "rows_16_mod_32": [("{ return round4(d) + 4; }", "{ return (round4(d) + 47) / 32 * 32 - 16; }")],
    "cta_positions_256": [("constexpr int kCtaPositions = 128;",
                           "constexpr int kCtaPositions = 256;")],
    "probe_no_compute": [("    // scores of position quad_t of every tile with every query\n",
                          "    continue;  // probe\n")],
    "probe_no_combine": [("  cluster.sync();  // every CTA's m, l and acc are written and visible\n",
                          "  if (tid >= 0) return;  // probe\n")],
    "probe_launch_only": [("  // the table columns this CTA holds: from its range's first, or from the row's first\n",
                           "  cg::this_cluster().sync();\n"
                           "  if (tid >= 0) return;  // probe\n")],
}

SPLIT_PROBES = ("probe_no_compute", "probe_no_combine", "probe_launch_only")

_COMBINE_START = "  // combine the cluster's CTAs exactly, through distributed shared memory\n"
_COMBINE_END = "  cluster.sync();  // no CTA exits while another still reads its shared memory\n"
_KERNEL = "// kMaxW: a compile-time bound on W"

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
# remote writes) makes sure every CTA of the cluster has started.
_PUSH_COMBINE = """  cg::cluster_group cluster = cg::this_cluster();
  const int rec = 2 * W + W * D;
  float* recv_s = reinterpret_cast<float*>(bt_s + bt_held);  // rank 0: [S][m, l, acc]
  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");
  float* dst = cluster.map_shared_rank(recv_s, 0) + s * rec;
  for (int w = tid; w < W; w += kThreads) {
    dst[w] = m_s[w];
    dst[W + w] = l_s[w];
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < W * D) dst[2 * W + idx] = acc[k];
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\\n" ::: "memory");
  if (s != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");
  for (int idx = tid; idx < W * D; idx += kThreads) {
    const int w = idx / D, d = idx - w * D;
    float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      mr[r] = r < S ? recv_s[r * rec + w] : kNegInf;
      lr[r] = r < S ? recv_s[r * rec + W + w] : 0.f;
      ar[r] = r < S ? recv_s[r * rec + 2 * W + idx] : 0.f;
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
"""

# split-KV variants; the probe_* variants above (SPLIT_PROBES) time the
# split launch's parts as well
SPLIT_VARIANTS = {
    # (a16) a non-portable cluster of up to 16 CTAs, one per split up to 16
    "cluster16": [("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
                  ("    if (e != cudaSuccess) return static_cast<int>(e);\n    ready = true;\n",
                   "    if (e != cudaSuccess) return static_cast<int>(e);\n"
                   "    cudaFuncSetAttribute(paged_append_kernel<kMaxW, kSplit>,\n"
                   "                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
                   "    ready = true;\n")],
    # rounds of at most 3 tiles (a quarter of an SM's shared memory, as
    # the single-pass form): a 128-position range takes two rounds
    "split_stages3": [("kSmemLimit / (kSplit ? 2 : 4)", "kSmemLimit / 4")],
    # (b) partials in a global scratch, the last CTA to arrive combines
    "ticket": [((_COMBINE_START, _COMBINE_END), _TICKET_COMBINE),
               (_KERNEL, _TICKET_GLOBALS + _KERNEL),
               ("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = kSplit ? 0 : 1;\n")],
    # the combine pushed into rank 0's shared memory (one barrier)
    "push": [((_COMBINE_START, _COMBINE_END), _PUSH_COMBINE),
             ("  int* bt_s = qp_s + W;", "  asm volatile(\"barrier.cluster.arrive.relaxed.aligned;\\n\" ::: "
              "\"memory\");\n  int* bt_s = qp_s + W;"),
             ("static_cast<size_t>(bt_held));",
              "static_cast<size_t>(bt_held) + kMaxCluster * (2 * w + w * D));")],
}


OCCUPANCY_CU = r"""
extern "C" int ff_probe_max_active_clusters(int W, int D, int MB, int bs, int H, int B) {
  const int c = cluster_size(MB, bs);
  int stages = kMaxStages;
  while (stages > 1 && smem_bytes(W, D, MB, stages) > kSmemLimit / 4) --stages;
  cudaFuncSetAttribute(paged_append_kernel<1, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(kSmemLimit));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(W, D, MB, stages);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, paged_append_kernel<1, false>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
"""


def _substituted(base: str, name: str, subs) -> str:
    """``base`` with each (old, new) substitution made; an ``old`` of two
    texts replaces everything from the first through the second."""
    text = base
    for old, new in subs:
        if isinstance(old, tuple):
            if old[0] not in text or old[1] not in text:
                raise RuntimeError(f"{name}: {old[0][:60]!r} ... is not in the source")
            start, end = text.index(old[0]), text.index(old[1]) + len(old[1])
            text = text[:start] + new + text[end:]
            continue
        if old not in text:
            raise RuntimeError(f"{name}: {old[:60]!r} is not in the source")
        text = text.replace(old, new)
    return text


def _inputs(torch, gen, ctx_lens, w, copies, nb=257, bs=16, h=12, d=64, mb=64):
    """``copies`` sets of (q, k, v, tables, positions) of the kernel phase
    of chip_smoke.py: tables over a random permutation of the blocks,
    window ``w`` ending at each context's last position (a context of 0
    is a padding-only slot)."""
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
    dev = torch.device("cuda")
    bt = torch.from_numpy(tables).to(dev)
    qp = torch.from_numpy(qpos.astype(np.int32)).to(dev)
    return [(torch.randn((len(ctx_lens), w, h, d), generator=gen).to(dev),
             torch.randn((nb, bs, h, d), generator=gen).to(dev),
             torch.randn((nb, bs, h, d), generator=gen).to(dev), bt, qp) for _ in range(copies)]


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
    import torch

    from flexflow_tpu_torch.ops.kernels import _build
    from flexflow_tpu_torch.ops.kernels import decode_attention as da

    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device is available", file=sys.stderr)
        return 2
    base = (_build.CSRC_DIR / "paged_attention.cu").read_text()
    sources = {"source": base + OCCUPANCY_CU}
    for name, subs in {**VARIANTS, **SPLIT_VARIANTS}.items():
        sources[name] = _substituted(base, name, subs)
    libs = {}
    for name, (so, _) in _compile(sources).items():
        lib = ctypes.CDLL(str(so))
        for fn in ("ff_paged_append_f32", "ff_paged_append_split_f32"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    print(_card())
    print("decode launch (W=1, D=64, 64 columns of 16, H=12, B=4): the card holds "
          f"{libs['source'].ff_probe_max_active_clusters(1, 64, 64, 16, 12, 4)} clusters at once")

    def single(lib):
        def run(q, k, v, bt, qp):
            b, w, h, d = q.shape
            out = torch.empty_like(q)
            rc = lib.ff_paged_append_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(),
                                         qp.data_ptr(), out.data_ptr(), b, w, h, d, k.shape[1],
                                         bt.shape[1], d ** -0.5,
                                         torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
            return out
        return run

    def split(lib, s, max_ctas=da.MAX_CLUSTER):
        def run(q, k, v, bt, qp):
            b, w, h, d = q.shape
            ctas, cols = da.split_plan(s, bt.shape[1], max_ctas)
            out = torch.empty_like(q)
            rc = lib.ff_paged_append_split_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(), qp.data_ptr(),
                out.data_ptr(), b, w, h, d, k.shape[1], bt.shape[1], ctas, cols, d ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
            return out
        return run

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
        sets = _inputs(torch, gen, ctx, w, copies=8)
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
