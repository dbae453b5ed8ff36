"""Per-op and per-collective cost estimation (port of
``flexflow_tpu/search/cost_model.py``).

Reference: the reference measures op cost by running the real kernel on a
GPU bracketed with CUDA events (Op::measure_operator_cost per op; generic
wrapper include/flexflow/operator.h:127 inner_measure_operator_cost),
cached by (op params, machine view) — src/runtime/simulator.cc:588-628 —
and uses analytic transfer estimates for parallel ops
(simulator.cc:630-716 estimate_xfer_cost / repartition cost).

The primary model is the JAX package's analytic roofline over the op's
OpCost (flops, bytes) with its efficiency derates, so a CPU search gives
the JAX package's numbers. ``measure=True`` times the port's op forward
on the card with CUDA events (``calibration.measure_lowered_op``) and
caches by the same (params, n_parts) key the reference uses. Collective
costs are closed-form ring/tree models over the device links
(bandwidth/latency from the ``TPUChipSpec``: the card's NVLink in its
``ici_*`` fields).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.tensor import TensorSpec
from ..core.types import DataType, OpType, ParameterSyncOption
from ..ops.base import OpCost, get_op_def
from ..parallel.machine import MachineSpec, MachineView

# utilization derates: achievable fraction of peak (empirical; roofline
# models consistently overestimate, see scaling-book style derates)
MXU_EFFICIENCY = 0.55
HBM_EFFICIENCY = 0.8
ICI_EFFICIENCY = 0.85
KERNEL_OVERHEAD = 2e-6  # fixed per-op launch/fusion-boundary overhead (s)


@dataclasses.dataclass
class CostMetrics:
    """Per-op simulation record (reference: CostMetrics simulator.h:54-88)."""

    forward_time: float = 0.0
    backward_time: float = 0.0
    sync_time: float = 0.0
    memory_requirement: float = 0.0  # bytes per device
    # truth-ledger tag (obs/truth.py): the prediction this estimate
    # registered, so a later measurement of the same op signature joins
    # it into a (predicted, measured) pair
    prediction_id: Optional[int] = None

    @property
    def total_time(self) -> float:
        return self.forward_time + self.backward_time + self.sync_time


class CostModel:
    """Analytic (optionally calibrated) op + collective cost model.

    ``calibration`` supplies per-class derates and exact measured op
    times from search/calibration.py; ``measure`` additionally times any
    op the calibration has no entry for, live on the default device, and
    writes the result through to the on-disk cache.
    """

    def __init__(
        self,
        machine: Optional[MachineSpec] = None,
        measure: bool = False,
        calibration=None,
        ledger=None,
    ):
        from .calibration import Calibration

        self.machine = machine or MachineSpec()
        self.chip = self.machine.chip
        self.measure = measure
        self.calibration = calibration if calibration is not None else Calibration()
        # truth ledger (obs/truth.py): every estimate this model hands
        # the search registers its predicted forward time, so a later
        # on-device measurement of the same signature grades it
        if ledger is None:
            from ..obs.truth import GLOBAL_LEDGER as ledger  # noqa: F811
        self.ledger = ledger
        # cache: (op_type, params, shard shapes) -> CostMetrics
        # (reference: hash_to_operator_cost, simulator.cc:588-628)
        self._cache: Dict[Tuple, CostMetrics] = {}
        self._measure_cache: Dict[Tuple, float] = {}

    # ------------------------------------------------------------ op cost
    def op_cost_metrics(
        self,
        op_type: OpType,
        params,
        input_specs: Sequence[TensorSpec],
        output_specs: Sequence[TensorSpec],
        n_parts: int = 1,
    ) -> CostMetrics:
        """Estimate fwd+bwd time for one *shard* of the op when its
        sample/attr dims are split across ``n_parts`` devices."""
        key = (
            op_type,
            params,
            tuple(s.shape + (s.dtype,) for s in input_specs),
            n_parts,
        )
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        op_def = get_op_def(op_type)
        cost: OpCost = op_def.cost(params, list(input_specs), list(output_specs))
        # per-shard work
        flops = cost.flops / max(1, n_parts)
        bytes_hbm = cost.bytes_accessed / max(1, n_parts)
        dtype = input_specs[0].dtype if input_specs else DataType.FLOAT
        roofline = self._roofline_time(flops, bytes_hbm, dtype)
        fwd = roofline * self.calibration.derate(op_type)
        source = (
            f"analytic roofline x derate {self.calibration.derate(op_type):.2f}"
        )
        calibrated = self.calibration.lookup(op_type, params, input_specs, n_parts)
        if calibrated is not None:
            fwd = calibrated
            source = (
                f"calibration table entry from "
                f"{getattr(self.calibration, 'source', '(in-memory)')} "
                f"({self.calibration.device_kind})"
            )
        # predict side of the truth ledger (obs/truth.py): register the
        # forward-time estimate under the device-qualified cost key
        # (op:<device>:<cost_key> — the device this model's calibration
        # claims to describe) so a later measurement of this exact
        # signature ON THAT DEVICE grades it. Cache misses only — the
        # per-signature cache below makes this once-per-signature, off
        # the search's hot path. Registered BEFORE measure mode runs:
        # measure_lowered_op writes its result through to the SAME
        # ledger key, so the pre-measure estimate must already be there
        # for the pair to join.
        from .calibration import op_ledger_key

        ledger_key = op_ledger_key(
            self.calibration.device_kind, op_type, params, input_specs, n_parts
        )
        shapes = ",".join("x".join(str(d) for d in s.shape) for s in input_specs)
        dt = input_specs[0].dtype.name.lower() if input_specs else "?"
        label = f"{op_type.name} {shapes} {dt} /{n_parts}"
        # alarm only when a calibration table vouched for the number: a
        # raw roofline x derate estimate is expected to miss (that is
        # why derates exist) and must not raise "calibration drift"
        pid = self.ledger.predict(ledger_key, fwd, label=label,
                                  provenance=source,
                                  alarm=calibrated is not None)
        if calibrated is None and self.measure:
            measured = self._try_measure(
                op_type, params, input_specs, n_parts,
                analytic_hint=roofline, ledger_key=ledger_key,
            )
            if measured is not None:
                fwd = measured
                source = "live on-device measurement (measure mode)"
                # refresh in place (same prediction id): future
                # measurements grade against the measured value, not the
                # superseded analytic estimate — and a live measurement
                # IS calibrated evidence, so drift off it may alarm
                self.ledger.predict(ledger_key, fwd, label=label,
                                    provenance=source, alarm=True)
        # backward ≈ 2x forward for matmul-dominated ops (dL/dx + dL/dw),
        # ≈ 1x for elementwise (reference measures separately; same ratio)
        bwd_factor = 2.0 if cost.flops > 0 else 1.0
        m = CostMetrics(
            forward_time=fwd,
            backward_time=fwd * bwd_factor,
            memory_requirement=cost.memory_bytes / max(1, n_parts),
            prediction_id=pid,
        )
        self._cache[key] = m
        return m

    def _roofline_time(self, flops: float, bytes_hbm: float, dtype: DataType) -> float:
        peak = self.chip.bf16_flops if dtype in (DataType.BFLOAT16, DataType.HALF) else self.chip.f32_flops
        t_compute = flops / (peak * MXU_EFFICIENCY)
        t_memory = bytes_hbm / (self.chip.hbm_bandwidth * HBM_EFFICIENCY)
        return max(t_compute, t_memory) + KERNEL_OVERHEAD

    def _try_measure(
        self, op_type, params, input_specs, n_parts,
        analytic_hint=None, ledger_key=None,
    ) -> Optional[float]:
        """Measured calibration: jit the op's lowering on the default
        device and time it (the reference's inner_measure_operator_cost
        on TPU); the result is written through to the on-disk cache.
        ``analytic_hint`` (the caller's roofline estimate) sizes the
        timing loop so the measurement resolves without escalation;
        ``ledger_key`` routes the measurement to the exact truth-ledger
        entry this model's prediction registered under."""
        key = (op_type, params, tuple((s.shape, s.dtype) for s in input_specs), n_parts)
        if key in self._measure_cache:
            return self._measure_cache[key]
        from .calibration import cost_key, measure_lowered_op

        t = measure_lowered_op(
            op_type, params, input_specs, n_parts,
            analytic_hint=analytic_hint, ledger=self.ledger,
            ledger_key=ledger_key,
        )
        self._measure_cache[key] = t  # type: ignore
        if t is not None:
            self.calibration.entries[cost_key(op_type, params, input_specs, n_parts)] = t
            if self.calibration.device_kind != "analytic":
                try:
                    self.calibration.save()
                except OSError:
                    pass
        return t

    # ------------------------------------------------------- comm costs
    def link_bandwidth(self, intra_node: bool) -> float:
        bw = self.chip.ici_bandwidth if intra_node else self.machine.chip.dcn_bandwidth
        return bw * ICI_EFFICIENCY

    def link_latency(self, intra_node: bool) -> float:
        return self.chip.ici_latency if intra_node else self.chip.dcn_latency

    def _view_spans_nodes(self, view: Optional[MachineView]) -> bool:
        if view is None:
            return self.machine.num_nodes > 1
        ids = view.device_ids()
        per = self.machine.devices_per_node
        return len({i // per for i in ids}) > 1

    def p2p_time(self, nbytes: float, intra_node: bool = True) -> float:
        return self.link_latency(intra_node) + nbytes / self.link_bandwidth(intra_node)

    def allreduce_time(
        self,
        nbytes: float,
        n: int,
        option: ParameterSyncOption = ParameterSyncOption.DEFAULT,
        intra_node: bool = True,
        include_overhead: bool = True,
        groups: int = 1,
    ) -> float:
        """Closed-form allreduce cost over n devices.

        ``groups``: number of INDEPENDENT group instances of this
        collective launched together (a dp x tp mesh psums over
        n_dev/n groups of n at once). Charged as
        coll_overhead * groups**chip.coll_groups_alpha — alpha 0 (the
        default, and the round-5 honest-measurement refit for the CPU
        host class) means concurrent groups add NO cost; a host class
        that does serialize them can set alpha up to 1.

        Reference: the fork's AllreduceHelper expands ring / butterfly /
        double-binary-tree patterns into p2p sends and simulates them
        (simulator.h:614-651, simulator.cc:2870+). On the ICI torus the
        same algebra holds with per-hop latency L and link bandwidth B:
          ring:      2(n-1)/n * bytes/B          + 2(n-1) L
          butterfly: log2(n) * bytes/B           + log2(n) L  (recursive halving-doubling)
          DBT:       2 * bytes/B (pipelined)     + 2 log2(n) L

        ``include_overhead=False`` drops the per-invocation rendezvous
        constant: callers modeling FUSABLE collectives (per-weight
        gradient syncs that XLA combines into one launch per replica
        group) charge the constant once per group themselves.
        """
        if n <= 1 or nbytes <= 0:
            return 0.0
        B = self.link_bandwidth(intra_node)
        L = self.link_latency(intra_node)
        C = (
            self.chip.coll_overhead
            * max(1, groups) ** getattr(self.chip, "coll_groups_alpha", 0.0)
            if include_overhead
            else 0.0
        )
        if option == ParameterSyncOption.BUTTERFLY:
            k = math.log2(n) if n > 1 else 1.0
            return C + k * L + math.ceil(k) * (nbytes / n) * 2 / B * (n / 2)
        if option == ParameterSyncOption.DOUBLE_BINARY_TREE:
            k = math.log2(n) if n > 1 else 1.0
            return C + 2 * k * L + 2 * nbytes / B
        # DEFAULT and RING: bandwidth-optimal ring
        return C + 2 * (n - 1) * L + 2 * (n - 1) / n * nbytes / B

    def all_gather_time(self, nbytes_total: float, n: int, intra_node: bool = True) -> float:
        if n <= 1:
            return 0.0
        B = self.link_bandwidth(intra_node)
        L = self.link_latency(intra_node)
        return self.chip.coll_overhead + (n - 1) * L + (n - 1) / n * nbytes_total / B

    def reduce_scatter_time(self, nbytes_total: float, n: int, intra_node: bool = True) -> float:
        return self.all_gather_time(nbytes_total, n, intra_node)

    def all_to_all_time(self, nbytes_total: float, n: int, intra_node: bool = True) -> float:
        if n <= 1:
            return 0.0
        B = self.link_bandwidth(intra_node)
        L = self.link_latency(intra_node)
        # each device exchanges (n-1)/n of its shard; torus bisection ~n/4 links
        bisection = max(1, n // 4)
        return (
            self.chip.coll_overhead
            + (n - 1) * L / n
            + (nbytes_total * (n - 1) / n) / (B * bisection)
        )

    # ------------------------------------------------- parallel-op xfers
    def xfer_time(
        self,
        op_type: OpType,
        nbytes_total: float,
        degree: int,
        intra_node: bool = True,
    ) -> float:
        """Analytic resharding cost per parallel op (reference:
        Simulator::estimate_xfer_cost simulator.cc:671 + the repartition
        special case :630)."""
        if degree <= 1 or nbytes_total <= 0:
            return 0.0
        if op_type == OpType.REPARTITION:
            # scatter: each dst gets 1/degree, all moves in parallel over links
            return self.p2p_time(nbytes_total / degree, intra_node)
        if op_type == OpType.COMBINE:
            return self.all_gather_time(nbytes_total, degree, intra_node)
        if op_type == OpType.REPLICATE:
            # broadcast along ring: pipelined, ~bytes/B + (d-1)L
            return (degree - 1) * self.link_latency(intra_node) + nbytes_total / self.link_bandwidth(intra_node)
        if op_type == OpType.REDUCTION:
            return self.reduce_scatter_time(nbytes_total, degree, intra_node)
        if op_type == OpType.ALLREDUCE:
            return self.allreduce_time(nbytes_total, degree, intra_node=intra_node)
        if op_type == OpType.FUSED_PARALLEL:
            return self.all_to_all_time(nbytes_total, degree, intra_node)
        return self.p2p_time(nbytes_total, intra_node)

    def grad_sync_time(
        self,
        weight_bytes: float,
        view: Optional[MachineView],
        n_replicas: int,
        option: ParameterSyncOption = ParameterSyncOption.DEFAULT,
    ) -> float:
        """Gradient allreduce for one parameter (reference: nccl_update_task
        optimizer.cc:261 — allreduce over the weight's machine view)."""
        intra = not self._view_spans_nodes(view)
        return self.allreduce_time(weight_bytes, n_replicas, option, intra)
