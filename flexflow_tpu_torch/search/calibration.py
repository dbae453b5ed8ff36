"""Op-cost calibration for the search's cost model (port of
``flexflow_tpu/search/calibration.py``).

Reference: the reference times every candidate op on the real device
(Op::measure_operator_cost via inner_measure_operator_cost,
include/flexflow/operator.h:127) and caches the result keyed by op
params + machine view (src/runtime/simulator.cc:588-628).

The calibration is class-level, as the JAX package's: a small suite of
representative ops (``default_suite``: BERT-Base's shapes, its attention
included) is timed once per device kind, and the ratio measured /
analytic roofline becomes a derate for that op class (matmul-bound or
memory-bound); exact per-op measurements are kept as entries. On the
card an op is timed as the port runs it: its forward (the attention's
runs the flash kernel) captured ``inner`` times into one CUDA graph,
replayed between CUDA events. Everything persists to an on-disk JSON
cache keyed by device kind (``cache_dir``), with factory tables under
``calibration_data/`` (the JAX package's, copied).

``chip_spec_for`` maps a device kind to its peak figures: the JAX
package's presets for its device kinds, and the H100's data-sheet
figures for the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType
from ..ops.base import get_op_def
from ..parallel.machine import MachineSpec, TPUChipSpec

# op classes for derate sharing: FLOPs-dominated ops ride the MXU,
# everything else is HBM-bandwidth-bound
MATMUL_OPS = frozenset(
    {
        OpType.LINEAR,
        OpType.BATCH_MATMUL,
        OpType.MULTIHEAD_ATTENTION,
        OpType.CONV2D,
    }
)


def op_class(op_type: OpType) -> str:
    return "matmul" if op_type in MATMUL_OPS else "memory"


def cost_key(op_type: OpType, params, input_specs: Sequence[TensorSpec], n_parts: int) -> str:
    shapes = ";".join(f"{tuple(s.shape)}:{s.dtype.name}" for s in input_specs)
    return f"{op_type.name}|{params!r}|{shapes}|{n_parts}"


def op_ledger_key(
    device_kind: str, op_type: OpType, params,
    input_specs: Sequence[TensorSpec], n_parts: int,
) -> str:
    """Truth-ledger key for one op signature ON one device kind
    (``op:<device-slug>:<cost_key>``). The device lives in the key so a
    prediction made for a hypothetical machine (a v5e what-if searched
    on a CPU dev box) can never join a measurement taken on different
    hardware and raise a false drift alarm."""
    return f"op:{_slug(device_kind)}:{cost_key(op_type, params, input_specs, n_parts)}"


def detected_device_kind(default: str = "cpu") -> str:
    """The device kind the port runs on: the card's name
    (``torch.cuda.get_device_name``) where there is one, else ``"cpu"``
    — the one shared detection used by chip resolution, the truth ledger
    and the strategy predictor."""
    try:
        import torch

        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
    except Exception:
        pass
    return default


def mesh_device_kind(kind: str, count: int) -> str:
    """Mesh geometry as a device kind: ``"TPU v5e x4"`` — kind x chip
    count. :func:`chip_spec_for` parses the suffix back into an
    AGGREGATE chip spec (peaks and capacity scaled by the count), so a
    multi-chip serving engine's MFU divides by the mesh's peak FLOPs
    instead of one chip's — a 4-chip engine reporting against a single
    chip would happily claim >100% MFU."""
    if count <= 1:
        return kind
    return f"{kind} x{int(count)}"


@dataclasses.dataclass
class Calibration:
    """Measured timing data for one device kind."""

    device_kind: str = "analytic"
    # class -> multiplier applied to the analytic roofline time
    # (>1 = device slower than roofline; seeded at 1.0 = trust roofline)
    derates: Dict[str, float] = dataclasses.field(default_factory=dict)
    # exact measured seconds per op signature (reference: the
    # hash_to_operator_cost cache, simulator.cc:588-628)
    entries: Dict[str, float] = dataclasses.field(default_factory=dict)
    # suite ops whose measurement never resolved above the jitter floor
    # (cost keys). Persisted so a partial table is LOUD: consumers and
    # the evidence log can see exactly which ops fell back to
    # roofline x derate and which classes the derate geomean missed.
    failed: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # where this table came from (file path when loaded from disk):
        # ends the truth ledger's drift-blame string so a stale table is
        # named, not just detected. Plain attribute, not a field — it
        # must not ride to_json into the persisted tables.
        self.source = "(in-memory)"

    def derate(self, op_type: OpType) -> float:
        return self.derates.get(op_class(op_type), 1.0)

    def lookup(self, op_type: OpType, params, input_specs, n_parts: int) -> Optional[float]:
        return self.entries.get(cost_key(op_type, params, input_specs, n_parts))

    # ----------------------------------------------------------- persist
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Calibration":
        d = json.loads(text)
        return cls(
            device_kind=d.get("device_kind", "analytic"),
            derates=dict(d.get("derates", {})),
            entries=dict(d.get("entries", {})),
            failed=list(d.get("failed", [])),
        )

    def save(self, path: Optional[Path] = None) -> Path:
        path = path or (cache_dir() / f"opcosts_{_slug(self.device_kind)}.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(self.to_json() + "\n")
        tmp.replace(path)
        return path


def _slug(kind: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in kind.lower()).strip("_") or "unknown"


def cache_dir() -> Path:
    """The user cache: ``$FLEXFLOW_TPU_TORCH_CACHE``, else
    ``$XDG_CACHE_HOME/flexflow_tpu_torch`` (``~/.cache`` by default)."""
    env = os.environ.get("FLEXFLOW_TPU_TORCH_CACHE")
    if env:
        return Path(env)
    return Path(os.environ.get("XDG_CACHE_HOME", Path.home() / ".cache")) / "flexflow_tpu_torch"


_DATA_DIR = Path(__file__).parent / "calibration_data"


def load_calibration(device_kind: str) -> Optional[Calibration]:
    """User cache first, then the committed factory table."""
    for base in (cache_dir(), _DATA_DIR):
        p = base / f"opcosts_{_slug(device_kind)}.json"
        if p.exists():
            try:
                cal = Calibration.from_json(p.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            cal.source = str(p)
            return cal
    return None


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _shard_inputs(input_specs: Sequence[TensorSpec], n_parts: int) -> List[TensorSpec]:
    """One shard's input specs: the first input's leading dim split
    ``n_parts`` ways, as the JAX package measures."""
    out = []
    for i, s in enumerate(input_specs):
        shape = list(s.shape)
        if i == 0 and shape and shape[0] % n_parts == 0:
            shape[0] //= n_parts
        out.append(TensorSpec(tuple(shape), s.dtype))
    return out


def _host_array(rs, shape, dtype: DataType, scale: float = 1.0):
    """Random inputs from ``rs``; integer inputs (token ids) are drawn in
    [0, 4), valid indices into any table the suite gathers from."""
    import numpy as np

    x = rs.randn(*shape) * scale
    if dtype in (DataType.INT32, DataType.INT64):
        return np.abs(x).astype(np.int64) % 4
    return x


def _op_runner(op_type: OpType, params, shard_specs: Sequence[TensorSpec], device):
    """A closure running one forward of the op on ``device`` (no autograd)
    over random inputs and weights."""
    import numpy as np
    import torch

    from ..ops.base import LowerCtx

    op_def = get_op_def(op_type)
    rs = np.random.RandomState(0)
    args = [torch.as_tensor(_host_array(rs, s.shape, s.dtype)).to(device, s.dtype.torch)
            for s in shard_specs]
    weights = {
        w.name: torch.as_tensor(_host_array(rs, w.spec.shape, w.spec.dtype, 0.02)).to(
            device, w.spec.dtype.torch)
        for w in op_def.weight_specs(params, list(shard_specs))
    }
    ctx = LowerCtx(training=False)

    def run():
        with torch.no_grad():
            return op_def.lower(params, args, weights, ctx)

    return run


def _time_cuda(run, inner: int, reps: int) -> float:
    """Seconds a call: ``inner`` calls captured into one CUDA graph,
    replayed ``reps`` times between CUDA events, the fastest replay.
    The flash kernels' launches are counted per replay
    (``flash_attention.capturing`` / ``count_replay``). An op that cannot
    be captured is timed eagerly between the same events."""
    import torch

    from ..ops.kernels import flash_attention as fa

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):  # warm-up: cuBLAS handles, cuDNN plans, kernel loads
            run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured: Dict[str, int] = {}
    try:
        with fa.capturing() as captured, torch.cuda.graph(graph):
            for _ in range(inner):
                run()
        launch = graph.replay
    except Exception:
        captured = {}

        def launch():
            for _ in range(inner):
                run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(max(reps, 1)):
        start.record()
        launch()
        end.record()
        end.synchronize()
        fa.count_replay(captured)
        best = min(best, start.elapsed_time(end) * 1e-3 / inner)
    return best


def _time_host(run, inner: int, reps: int) -> float:
    """Seconds a call on the CPU: the fastest of ``reps`` loops of
    ``inner`` calls on the host clock."""
    run()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        for _ in range(inner):
            run()
        best = min(best, (time.perf_counter() - t0) / inner)
    return best


def measure_lowered_op(
    op_type: OpType,
    params,
    input_specs: Sequence[TensorSpec],
    n_parts: int = 1,
    inner: int = 32,
    reps: int = 3,
    analytic_hint: Optional[float] = None,
    ledger=None,
    ledger_key: Optional[str] = None,
) -> Optional[float]:
    """Time one shard of the op's forward as the port runs it (the
    reference's inner_measure_operator_cost, operator.h:127), in seconds
    a call, or None when it could not run.

    On the card (the default device where there is one) the calls are
    captured into a CUDA graph and replayed between CUDA events (the JAX
    package's trip-count slope cancelled its per-dispatch floor; a graph
    replay has none to cancel). ``analytic_hint`` (the roofline
    estimate) sizes the calls a replay holds to ~1 ms of device time,
    between ``inner`` and 1024. On the CPU the calls run on the host
    clock. Every measurement is written to the truth ledger under the
    device-qualified key (``op_ledger_key``), as the JAX package's."""
    try:
        import torch

        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        run = _op_runner(op_type, params, _shard_inputs(input_specs, n_parts), device)
        if device.type == "cuda":
            if analytic_hint:
                inner = max(inner, min(1024, int(1e-3 / analytic_hint)))
            result = _time_cuda(run, inner, reps)
        else:
            result = _time_host(run, max(1, inner // 4), reps)
    except Exception:
        return None
    if not result > 0:
        return None
    # measure side of the truth ledger: joins the cost model's prediction
    # for the same (device, op, params, shapes, n_parts) key
    try:
        led = ledger
        if led is None:
            from ..obs.truth import GLOBAL_LEDGER as led
        key = ledger_key or op_ledger_key(
            detected_device_kind(), op_type, params, input_specs, n_parts)
        led.measure(key, result)
    except Exception:
        pass
    return result


def default_suite(dtype: DataType = DataType.BFLOAT16) -> List[Tuple[OpType, object, List[TensorSpec]]]:
    """Representative (op, params, inputs) covering both op classes at
    MXU-friendly sizes (the shapes BERT-class models actually run)."""
    from ..ops.attention import MultiHeadAttentionParams
    from ..ops.batch_matmul import BatchMatmulParams
    from ..ops.conv import Conv2DParams
    from ..ops.elementwise import ElementUnaryParams
    from ..ops.embedding import EmbeddingParams
    from ..ops.linear import LinearParams
    from ..ops.norm import LayerNormParams
    from ..ops.softmax import SoftmaxParams

    B, S, H, F = 16, 128, 768, 3072
    x = TensorSpec((B * S, H), dtype)
    seq = TensorSpec((B, S, H), dtype)
    return [
        # vision + embedding coverage (ResNet stage-2-ish conv; BERT
        # vocab-sized gather, integer input -> single-shot path)
        (
            OpType.CONV2D,
            Conv2DParams(out_channels=128, kernel=(3, 3), stride=(1, 1),
                         padding=(1, 1), dtype=dtype),
            [TensorSpec((16, 64, 56, 56), dtype)],
        ),
        (
            OpType.EMBEDDING,
            EmbeddingParams(num_entries=30522, out_dim=H, dtype=dtype),
            [TensorSpec((B, S), DataType.INT32)],
        ),
        (OpType.LINEAR, LinearParams(out_dim=F, use_bias=True, dtype=dtype), [x]),
        (OpType.LINEAR, LinearParams(out_dim=H, use_bias=True, dtype=dtype), [TensorSpec((B * S, F), dtype)]),
        (
            OpType.BATCH_MATMUL,
            BatchMatmulParams(),
            [TensorSpec((B * 12, S, 64), dtype), TensorSpec((B * 12, 64, S), dtype)],
        ),
        (
            OpType.MULTIHEAD_ATTENTION,
            MultiHeadAttentionParams(embed_dim=H, num_heads=12, dtype=dtype),
            [seq, seq, seq],
        ),
        (OpType.LAYERNORM, LayerNormParams(axes=(2,), dtype=dtype), [seq]),
        (OpType.SOFTMAX, SoftmaxParams(axis=-1), [TensorSpec((B * 12, S, S), dtype)]),
        (OpType.RELU, ElementUnaryParams(op=OpType.RELU), [TensorSpec((B * S, F), dtype)]),
        (OpType.GELU, ElementUnaryParams(op=OpType.GELU), [TensorSpec((B * S, F), dtype)]),
    ]


def calibrate(
    machine: Optional[MachineSpec] = None,
    device_kind: Optional[str] = None,
    suite: Optional[Sequence] = None,
    save: bool = True,
) -> Calibration:
    """Run the calibration suite on the default device (the card where
    there is one) and derive per-class derates (measured / analytic
    roofline). Ratios are combined per class by geometric mean; exact
    measurements are kept as entries, failed ones in ``failed``."""
    import numpy as np

    from .cost_model import CostModel

    if device_kind is None:
        device_kind = detected_device_kind()
    machine = machine or MachineSpec(num_nodes=1, devices_per_node=1, chip=chip_spec_for(device_kind))
    base = CostModel(machine)  # uncalibrated roofline
    cal = Calibration(device_kind=device_kind)
    # calls a timed replay holds at least (sized up from the analytic
    # hint on the card); few on the CPU, where ops are slow
    inner = 8 if device_kind == "cpu" else 32
    ratios: Dict[str, List[float]] = {}
    for op_type, params, specs in suite or default_suite():
        op_def = get_op_def(op_type)
        out_specs = op_def.infer_output_specs(params, list(specs))
        analytic = base._roofline_time(
            *_work_of(op_def, params, specs, out_specs), specs[0].dtype
        )
        if analytic <= 0:
            continue  # degenerate roofline: the ratio would be dropped anyway
        measured = measure_lowered_op(
            op_type, params, specs, inner=inner, analytic_hint=analytic
        )
        if measured is None:
            cal.failed.append(cost_key(op_type, params, specs, 1))
            continue
        cal.entries[cost_key(op_type, params, specs, 1)] = measured
        ratios.setdefault(op_class(op_type), []).append(measured / analytic)
    for cls_name, rs in ratios.items():
        cal.derates[cls_name] = float(np.exp(np.mean(np.log(rs))))
    if save and cal.entries:
        cal.save()
    return cal


def _work_of(op_def, params, input_specs, output_specs) -> Tuple[float, float]:
    c = op_def.cost(params, list(input_specs), list(output_specs))
    return c.flops, c.bytes_accessed


def load_or_calibrate(
    machine: Optional[MachineSpec] = None,
    allow_measure: bool = False,
    device_kind: Optional[str] = None,
) -> Calibration:
    """Resolution order: on-disk cache -> committed factory table ->
    live calibration (only when allow_measure) -> analytic default.

    ``device_kind`` forces the table key; pass "cpu" to calibrate the CPU
    explicitly (without a card the detected kind is "analytic", so
    ordinary searches in CPU test runs never pay a measurement suite).
    """
    if device_kind is None:
        device_kind = detected_device_kind(default="analytic")
    if device_kind == "analytic":
        return Calibration()
    hit = load_calibration(device_kind)
    if hit is not None:
        return hit
    if allow_measure:
        return calibrate(machine, device_kind=device_kind)
    return Calibration(device_kind=device_kind)


# ---------------------------------------------------------------------------
# recalibration from the truth ledger (obs/truth.py)
# ---------------------------------------------------------------------------


def recalibration_suggestions(ledger=None, min_rel_err: float = 0.25) -> List[Dict]:
    """Drifting ``op:*`` ledger entries -> suggested calibration-table
    updates. Each suggestion carries the cost key, the stale predicted
    seconds, the measured p50 that should replace it, and the blame
    string — the "the simulator is lying, now what?" hand-off."""
    if ledger is None:
        from ..obs.truth import GLOBAL_LEDGER as ledger  # noqa: F811
    out: List[Dict] = []
    for e in ledger.report()["entries"]:
        if not e["key"].startswith("op:") or e["pairs"] < ledger.min_samples:
            continue
        parts = e["key"].split(":", 2)  # op:<device-slug>:<cost_key>
        if len(parts) != 3:
            continue
        ewma = e["rel_err_ewma"]
        if ewma is None or abs(ewma) < min_rel_err or e["measured_p50_s"] is None:
            continue
        out.append({
            "device": parts[1],
            "cost_key": parts[2],
            "label": e["label"],
            "predicted_s": e["predicted_s"],
            "measured_p50_s": e["measured_p50_s"],
            "rel_err": ewma,
            "blame": e["last_blame"] or (
                f"{e['label']}: predicted {e['predicted_s']:.3g}s, "
                f"measured p50 {e['measured_p50_s']:.3g}s, error {ewma:+.0%}"
            ),
        })
    return out


def apply_recalibration(
    cal: Calibration,
    suggestions: Optional[Sequence[Dict]] = None,
    ledger=None,
    min_rel_err: float = 0.25,
    save: bool = False,
) -> List[Dict]:
    """Fold measured medians back into ``cal.entries`` for every
    drifting op the ledger has evidence on; returns what was applied.
    ``save=True`` persists the refreshed table to the on-disk cache."""
    applied = [
        s for s in (
            suggestions if suggestions is not None
            else recalibration_suggestions(ledger, min_rel_err)
        )
        # never fold one device's measurements into another device's
        # table (suggestions carry the ledger key's device slug)
        if s.get("device") in (None, _slug(cal.device_kind))
    ]
    for s in applied:
        cal.entries[s["cost_key"]] = s["measured_p50_s"]
    if save and applied:
        try:
            cal.save()
        except OSError:
            pass
    return applied


# ---------------------------------------------------------------------------
# chip presets (peak numbers for detected hardware; bench + cost model)
# ---------------------------------------------------------------------------

_CHIP_PRESETS = {
    "v2": TPUChipSpec(name="v2", bf16_flops=22.5e12, f32_flops=22.5e12, hbm_bandwidth=0.35e12, hbm_capacity=8e9, ici_bandwidth=62.5e9, ici_links=4),
    "v3": TPUChipSpec(name="v3", bf16_flops=61.25e12, f32_flops=61.25e12, hbm_bandwidth=0.45e12, hbm_capacity=16e9, ici_bandwidth=81.25e9, ici_links=4),
    "v4": TPUChipSpec(name="v4", bf16_flops=275e12, f32_flops=137e12, hbm_bandwidth=1.23e12, hbm_capacity=32e9, ici_bandwidth=112.5e9, ici_links=6),
    "v5e": TPUChipSpec(name="v5e", bf16_flops=197e12, f32_flops=98.5e12, hbm_bandwidth=0.82e12, hbm_capacity=16e9, ici_bandwidth=56.25e9, ici_links=4),
    "v5p": TPUChipSpec(name="v5p", bf16_flops=459e12, f32_flops=115e12, hbm_bandwidth=2.76e12, hbm_capacity=95e9, ici_bandwidth=100e9, ici_links=6),
    "v6e": TPUChipSpec(name="v6e", bf16_flops=918e12, f32_flops=459e12, hbm_bandwidth=1.64e12, hbm_capacity=32e9, ici_bandwidth=112.5e9, ici_links=4),
    # CPU backend (honest simulator validation on the fallback path —
    # never compare a TPU roofline against a CPU wall clock): nominal
    # multicore-XLA peaks; the calibration derates correct the rest.
    # ici_*/coll_overhead model XLA host-platform virtual-device
    # collectives: memcpy-grade bandwidth plus a LARGE fixed cost per
    # collective invocation (cross-thread rendezvous).
    # REFITTED in round 5 after two honesty fixes: (a) the bench's
    # tp/hybrid "measurements" had been silently running REPLICATED
    # (strategies built for a different graph never applied — now a
    # compile-time error), and (b) bf16 models had been computing their
    # dense layers in f32. Against honest quiet dp/tp/hybrid bf16 steps
    # the fit is coll_overhead=0.25 with coll_groups_alpha=0 —
    # independent group instances of one collective do NOT serialize on
    # today's XLA host platform (the old x groups assumption came from
    # the replicated fake measurement) — giving ratios dp 0.73 /
    # tp 0.92 / hybrid 1.42 with measured-rank agreement. The pipeline
    # family is deliberately left OUT of the fitting set as a transfer
    # check (bench reports its ratio separately). Expect drift on very
    # different core counts, within the bench's [0.3, 3] band.
    "cpu": TPUChipSpec(name="cpu", bf16_flops=5e10, f32_flops=1e11, hbm_bandwidth=2e10, hbm_capacity=16e9, ici_bandwidth=1e9, ici_links=1, ici_latency=1e-3, coll_overhead=0.25, coll_groups_alpha=0.0),
}

# the card (NVIDIA H100 SXM, data sheet): dense bf16 on the tensor cores,
# fp32 on the CUDA cores, HBM3 bandwidth and size, NVLink 4 (18 links,
# 450 GB/s a direction in all) in the ici_* fields; the DCN fields keep
# the reference preset's. The same figures bound PERF.md's kernel rows.
# chip_spec_for names the spec after the card it was asked for.
_H100 = TPUChipSpec(name="NVIDIA H100", bf16_flops=989e12, f32_flops=67e12,
                    hbm_bandwidth=3.35e12, hbm_capacity=80e9, ici_bandwidth=450e9,
                    ici_links=18)

# virtual-device compute scaling for the CPU fallback: N virtual devices
# share one physical machine, so the bench divides per-device peaks by
# N * this factor; fitted jointly with the cpu preset above. The round-5
# value absorbs everything the per-op model can't see on this host
# class — thread-pool sharing across the virtual devices, XLA's bf16
# CPU emulation cost on the ops the class derates don't cover exactly,
# and reshard/fusion effects between ops — fitted against honest quiet
# dp/tp/hybrid bf16 step measurements (the suite's entries themselves
# are bf16, calibration_data/opcosts_cpu.json)
CPU_FITTED_CONTENTION = 5.0


def chip_spec_for(device_kind: str) -> TPUChipSpec:
    """Peak figures for a device kind: the JAX package's presets for its
    kinds (and ``TPUChipSpec()`` for an unknown one), the H100's for a
    name containing "H100" (``torch.cuda.get_device_name`` of the card)."""
    kind = device_kind.lower()
    # mesh geometry ("TPU v5e x4", from mesh_device_kind): resolve the
    # per-chip spec, then scale compute/memory peaks by the chip count —
    # the aggregate machine MFU and the serving roofline divide by.
    # Per-link ICI numbers stay per-chip (they do not add up).
    m = re.search(r"\s+x(\d+)$", kind)
    if m is not None:
        n = int(m.group(1))
        base = chip_spec_for(device_kind[: m.start()])
        if n <= 1:
            return base
        return dataclasses.replace(
            base,
            name=f"{base.name} x{n}",
            bf16_flops=base.bf16_flops * n,
            f32_flops=base.f32_flops * n,
            hbm_bandwidth=base.hbm_bandwidth * n,
            hbm_capacity=base.hbm_capacity * n,
        )
    if kind == "cpu":
        return _CHIP_PRESETS["cpu"]
    if "h100" in kind:
        return dataclasses.replace(_H100, name=device_kind)
    for sub, spec in (
        ("v6e", _CHIP_PRESETS["v6e"]),
        ("v6 lite", _CHIP_PRESETS["v6e"]),
        ("v6", _CHIP_PRESETS["v6e"]),
        ("v5e", _CHIP_PRESETS["v5e"]),
        ("v5 lite", _CHIP_PRESETS["v5e"]),
        ("v5litepod", _CHIP_PRESETS["v5e"]),
        ("v5p", _CHIP_PRESETS["v5p"]),
        ("v5", _CHIP_PRESETS["v5p"]),
        ("v4", _CHIP_PRESETS["v4"]),
        ("v3", _CHIP_PRESETS["v3"]),
        ("v2", _CHIP_PRESETS["v2"]),
    ):
        if sub in kind:
            return spec
    return TPUChipSpec()
