"""Probes of the paged attention kernel's design on one NVIDIA GPU.

    python3 -m flexflow_tpu_torch.tools.paged_probe

Builds copies of ``ops/kernels/csrc/paged_attention.cu`` with one design
choice changed each (a text substitution, :data:`VARIANTS`), all nvcc
runs at once, and times each at the serving path's shapes (decode B=4
W=1 contexts 731/18/0/377, append W=5, split-KV B=1 S=8 context 931;
H=12, D=64, 64 table columns of 16): device ms per call from a CUDA
graph of 16 calls over 8 copies of the cache (past the L2), replayed 5
times between CUDA events, in two rounds (forward order, then reverse).
Each variant is held against the plain version; the ``probe`` variants
give wrong results on purpose (they measure what a part of the kernel
costs). It also prints how many clusters of the decode launch the card
can hold at once (``cudaOccupancyMaxActiveClusters``).

Builds land in ``ops/kernels/_build/probe/``; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import sys

from flexflow_tpu_torch.tools.flash_probe import _card, _compile

# name -> [(text in the source, replacement)]
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
    "probe_no_combine": [("    cluster.sync();  // every CTA's m, l and acc are written and visible\n",
                          "    if (tid >= 0) return;  // probe\n")],
    "probe_launch_only": [("  // the table columns this CTA may read: its split's, or the whole row\n",
                           "  if constexpr (!kSplit) cg::this_cluster().sync();\n"
                           "  if (tid >= 0) return;  // probe\n")],
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
    for name, subs in VARIANTS.items():
        text = base
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old[:60]!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
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
                raise RuntimeError(f"launch failed: {rc}")
            return out
        return run

    def split(lib, s=8):
        def run(q, k, v, bt, qp):
            b, w, h, d = q.shape
            mb = bt.shape[1]
            acc = torch.empty((b, s, w, h, d), device=q.device)
            m = torch.empty((b, s, h, w), device=q.device)
            l = torch.empty_like(m)
            rc = lib.ff_paged_append_split_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bt.data_ptr(), qp.data_ptr(),
                acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, w, h, d, k.shape[1], mb, s,
                -(-mb // s), d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
            return da._combine_splits(acc, m, l, qp, q.dtype)
        return run

    gen = torch.Generator().manual_seed(0)
    cases = {"decode B=4 W=1": ([731, 18, 0, 377], 1, single),
             "append B=4 W=5": ([700, 40, 0, 300], 5, single),
             "split B=1 S=8 (with combine)": ([931], 1, split)}
    for case, (ctx, w, make) in cases.items():
        sets = _inputs(torch, gen, ctx, w, copies=8)
        want = da.reference_paged_append_attention(*sets[0])
        times = {name: [] for name in libs}
        for order in (list(libs), list(reversed(list(libs)))):
            for name in order:
                times[name].append(_graph_ms(torch, make(libs[name]), sets))
        for name, lib in libs.items():
            err = float((make(lib)(*sets[0]) - want).abs().max())
            print(f"{case:30s} {name:18s} ms " + " ".join(f"{t:.4f}" for t in times[name])
                  + f"  max abs err {err:.2e}")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
