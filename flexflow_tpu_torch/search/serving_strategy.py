"""Serving-layout search: pick the generation engine's tensor-parallel
degree with the machinery the training path searches with (port of
``flexflow_tpu/search/serving_strategy.py``).

For a (model, mesh) pair, every TP degree that divides the head count
and fits the mesh is a candidate. Each candidate is scored twice with
:func:`search.simulator.predict_strategy_time` over a transformer-
shaped PCG carrying :func:`parallel.strategy.megatron_strategy`'s
shardings: once at the PREFILL shape (one sequence, full context: the
compute-bound program, where sharding wins) and once at the DECODE
shape (batch of slots, one token: the latency/collective-bound program,
where sharding must pay for its all-reduces). The engine runs ONE mesh,
so the choice minimizes the steady-state blend (decode-weighted:
serving is decode-dominated) and the per-kind scores ride the metadata
so an operator can see what the other layout would have cost.

The scores rank layouts; they are not wall-clock promises: the graph is
a training-shaped proxy (no KV cache; matmul ops charge fwd+bwd), and
on a CPU host the per-collective rendezvous constant makes tp=1 win.
The chosen candidate's predictions register in the engine's
PredictionLedger under ``serving_strategy:{prefill,decode}``
(``GenerationEngine._register_strategy_predictions``). The device kind
is the port's (:func:`~.calibration.detected_device_kind`: the card's
name, or ``"cpu"``), so on the CPU every score equals the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ServingStrategyChoice:
    """The chosen serving layout + every candidate's scores."""

    tp_degree: int
    pinned: bool  # True when the caller fixed the degree (no search)
    prefill_s: float  # chosen candidate's predicted prefill step
    decode_s: float  # chosen candidate's predicted decode step
    device_kind: str
    mesh_devices: int
    candidates: List[Dict] = dataclasses.field(default_factory=list)

    def describe(self) -> Dict:
        return {
            "tp_degree": self.tp_degree,
            "pinned": self.pinned,
            "predicted_prefill_s": self.prefill_s,
            "predicted_decode_s": self.decode_s,
            "device_kind": self.device_kind,
            "mesh_devices": self.mesh_devices,
            "candidates": list(self.candidates),
        }


def tp_candidates(num_heads: int, mesh_devices: int) -> List[int]:
    """TP degrees that divide the KV heads and fit the mesh."""
    return [
        d for d in range(1, min(num_heads, mesh_devices) + 1)
        if num_heads % d == 0
    ]


def _build_graph(cfg, batch: int, seq: int):
    """A transformer PCG at the given (batch, seq) shape — the scoring
    proxy for one engine program."""
    from ..config import FFConfig
    from ..core.graph import PCGraph
    from ..models.transformer import TransformerConfig, build_transformer

    proxy = TransformerConfig(
        num_layers=cfg.num_layers,
        hidden_size=cfg.hidden_size,
        num_heads=cfg.num_heads,
        ff_size=cfg.ff_size,
        seq_length=max(1, seq),
        vocab_size=max(2, cfg.vocab_size),
        causal=True,
        dtype=cfg.dtype,
    )
    # a graph only: nothing is built or run on a device. Its guids are
    # given back: building an engine leaves the guids (and with them the
    # dropout keys) of every model built after it as they would have been
    start = next(PCGraph._guid_counter)
    try:
        model = build_transformer(FFConfig(batch_size=max(1, batch)), proxy, device="cpu")
    finally:
        PCGraph._guid_counter = itertools.count(start)
    return model.graph


def score_serving_layouts(
    cfg,
    mesh_devices: int,
    max_batch_slots: int = 4,
    prefill_len: Optional[int] = None,
    calibration=None,
) -> List[Dict]:
    """Score every TP candidate for (model, mesh): predicted prefill and
    decode step seconds per candidate, best-first by the decode-weighted
    blend. Host arithmetic only (graph build + cost-model walk)."""
    from ..parallel.strategy import megatron_strategy
    from ..parallel.machine import MachineSpec
    from .calibration import chip_spec_for, detected_device_kind
    from .simulator import predict_strategy_time

    kind = detected_device_kind()
    machine = MachineSpec(
        num_nodes=1, devices_per_node=max(1, mesh_devices),
        chip=chip_spec_for(kind),
    )
    prefill_len = prefill_len or cfg.seq_length
    g_prefill = _build_graph(cfg, batch=1, seq=prefill_len)
    g_decode = _build_graph(cfg, batch=max_batch_slots, seq=1)
    scored: List[Dict] = []
    for tp in tp_candidates(cfg.num_heads, mesh_devices):
        prefill_s = predict_strategy_time(
            g_prefill, megatron_strategy(g_prefill, dp=1, tp=tp),
            machine=machine, calibration=calibration,
        )
        decode_s = predict_strategy_time(
            g_decode, megatron_strategy(g_decode, dp=1, tp=tp),
            machine=machine, calibration=calibration,
        )
        scored.append({
            "tp_degree": tp,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            # serving is decode-dominated: one prefill amortizes over
            # ~max_new decode steps, so weight decode accordingly
            "blend_s": prefill_s + 16.0 * decode_s,
        })
    scored.sort(key=lambda c: (c["blend_s"], c["tp_degree"]))
    return scored


def choose_serving_strategy(
    cfg,
    mesh_devices: int,
    max_batch_slots: int = 4,
    prefill_len: Optional[int] = None,
    pinned_tp: Optional[int] = None,
    calibration=None,
) -> ServingStrategyChoice:
    """Choose the serving TP degree for (model, mesh). ``pinned_tp``
    skips the argmin (the degree is the caller's — benches and tests pin
    it to exercise real sharding on host meshes) but still scores every
    candidate so the metadata shows the road not taken."""
    from .calibration import detected_device_kind, mesh_device_kind

    scored = score_serving_layouts(
        cfg, mesh_devices, max_batch_slots=max_batch_slots,
        prefill_len=prefill_len, calibration=calibration,
    )
    if not scored:
        raise ValueError(
            f"no TP candidate divides {cfg.num_heads} heads over "
            f"{mesh_devices} device(s)"
        )
    if pinned_tp is not None:
        chosen = next(
            (c for c in scored if c["tp_degree"] == pinned_tp), None
        )
        if chosen is None:
            raise ValueError(
                f"pinned tp_degree {pinned_tp} is not a valid candidate "
                f"for {cfg.num_heads} heads over {mesh_devices} device(s) "
                f"(candidates: {[c['tp_degree'] for c in scored]})"
            )
    else:
        chosen = scored[0]
    return ServingStrategyChoice(
        tp_degree=chosen["tp_degree"],
        pinned=pinned_tp is not None,
        prefill_s=chosen["prefill_s"],
        decode_s=chosen["decode_s"],
        device_kind=mesh_device_kind(
            detected_device_kind(), chosen["tp_degree"]
        ),
        mesh_devices=mesh_devices,
        candidates=scored,
    )


def choose_pool_strategies(
    cfg,
    mesh_devices: int,
    max_batch_slots: int = 4,
    prefill_len: Optional[int] = None,
    pinned_prefill_tp: Optional[int] = None,
    pinned_decode_tp: Optional[int] = None,
    calibration=None,
) -> Dict[str, ServingStrategyChoice]:
    """Disaggregated serving: choose a TP degree PER POOL from one
    scored candidate set. The unified chooser minimizes the decode-
    weighted blend because one mesh must run both programs; split
    pools remove that coupling — the prefill pool takes the argmin of
    the compute-bound prefill score, the decode pool the argmin of the
    latency-bound decode score (DistServe/Splitwise: the two programs
    genuinely want different layouts, and the KV handoff wire is
    TP-agnostic so the degrees are free to differ). Returns
    ``{"prefill": choice, "decode": choice}``; pins behave as in
    :func:`choose_serving_strategy`."""
    from .calibration import detected_device_kind, mesh_device_kind

    scored = score_serving_layouts(
        cfg, mesh_devices, max_batch_slots=max_batch_slots,
        prefill_len=prefill_len, calibration=calibration,
    )
    if not scored:
        raise ValueError(
            f"no TP candidate divides {cfg.num_heads} heads over "
            f"{mesh_devices} device(s)"
        )
    kind = detected_device_kind()

    def pick(metric: str, pinned: Optional[int]) -> ServingStrategyChoice:
        if pinned is not None:
            chosen = next(
                (c for c in scored if c["tp_degree"] == pinned), None
            )
            if chosen is None:
                raise ValueError(
                    f"pinned tp_degree {pinned} is not a valid candidate "
                    f"for {cfg.num_heads} heads over {mesh_devices} "
                    f"device(s) (candidates: "
                    f"{[c['tp_degree'] for c in scored]})"
                )
        else:
            chosen = min(scored, key=lambda c: (c[metric], c["tp_degree"]))
        return ServingStrategyChoice(
            tp_degree=chosen["tp_degree"],
            pinned=pinned is not None,
            prefill_s=chosen["prefill_s"],
            decode_s=chosen["decode_s"],
            device_kind=mesh_device_kind(kind, chosen["tp_degree"]),
            mesh_devices=mesh_devices,
            candidates=scored,
        )

    return {
        "prefill": pick("prefill_s", pinned_prefill_tp),
        "decode": pick("decode_s", pinned_decode_tp),
    }
