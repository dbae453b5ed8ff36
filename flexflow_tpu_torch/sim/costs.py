"""Where the twin's step durations come from.

A discrete-event fleet simulator is only as honest as its cost table.
This module gives the twin three sources, strongest first:

* :meth:`SimCosts.from_ledger_export` — measured p50s from a
  PredictionLedger snapshot (``tools/obsreport.py predict --export``),
  i.e. what the live engine actually observed for ``prefill[bucket]``
  / ``decode`` / ``verify`` / ``kv_swap_in``. Loads are refused across
  device kinds, the same rule ``apply_recalibration`` enforces: one
  device's measurements are never folded into another device's table.
* :meth:`SimCosts.from_roofline` — the serving roofline
  (``obs.capacity.ServingFlops``). :meth:`SimCosts.from_strategy` (the
  strategy-search cost model, a tensor-parallel degree per pool:
  ``search/serving_strategy.py``'s scores).
* :meth:`SimCosts.fixed_tick` — every working iteration costs exactly
  ``dt``, mirroring ``loadgen.drive_virtual``'s virtual-clock tick
  loop. This is the sim-vs-live gating mode (``simfleet simcheck``):
  the live storm runs on the same virtual tick, so divergence measures
  the twin's *queueing/control* fidelity, not its cost table.

No clocks in here — costs are data, never measurements.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple


def _slug(kind: str) -> str:
    # the calibration module's device slug, duplicated so the sim
    # stays importable as pure host code
    return "".join(
        c if c.isalnum() else "_" for c in kind.lower()
    ).strip("_") or "unknown"


class SimCosts:
    """Per-step durations for the virtual fleet.

    ``prefill_s`` maps prompt buckets to seconds (lookup rounds a
    prompt up to its bucket, exactly like the engine pads); ``decode_s``
    is one fixed-shape decode step; ``handoff_per_block_s`` prices the
    disaggregated KV handoff wire per block; ``kv_swap_in_s`` is the
    decode pool's per-stream KV adoption cost. ``tick_s`` non-None
    switches the replicas into tick mode (see module docstring).
    """

    def __init__(
        self,
        *,
        device_kind: str,
        prefill_s: Dict[int, float],
        decode_s: float,
        verify_s: Optional[float] = None,
        kv_swap_in_s: float = 0.0,
        handoff_per_block_s: float = 0.0,
        tick_s: Optional[float] = None,
        source: str = "synthetic",
    ):
        if not prefill_s and tick_s is None:
            raise ValueError("a cost table needs at least one prefill bucket")
        self.device_kind = device_kind
        self.prefill_s = {int(k): float(v) for k, v in prefill_s.items()}
        self.decode_s = float(decode_s)
        self.verify_s = float(verify_s) if verify_s is not None else self.decode_s
        self.kv_swap_in_s = float(kv_swap_in_s)
        self.handoff_per_block_s = float(handoff_per_block_s)
        self.tick_s = float(tick_s) if tick_s is not None else None
        self.source = source

    # ------------------------------------------------------------- lookups
    @property
    def buckets(self) -> Tuple[int, ...]:
        return tuple(sorted(self.prefill_s))

    def prefill(self, prompt_len: int) -> float:
        """Cost of one prefill: the smallest bucket that fits the
        prompt (the engine's padding rule); prompts past the largest
        bucket pay the largest bucket's cost."""
        if self.tick_s is not None:
            return self.tick_s
        for b in self.buckets:
            if prompt_len <= b:
                return self.prefill_s[b]
        return self.prefill_s[self.buckets[-1]]

    def handoff_s(self, blocks: int) -> float:
        return self.handoff_per_block_s * max(0, blocks)

    def describe(self) -> Dict:
        return {
            "device_kind": self.device_kind,
            "source": self.source,
            "mode": "tick" if self.tick_s is not None else "cost",
            "tick_s": self.tick_s,
            "prefill_s": {str(k): v for k, v in sorted(self.prefill_s.items())},
            "decode_s": self.decode_s,
            "verify_s": self.verify_s,
            "kv_swap_in_s": self.kv_swap_in_s,
            "handoff_per_block_s": self.handoff_per_block_s,
        }

    # ---------------------------------------------------------- constructors
    @classmethod
    def fixed_tick(cls, dt: float, device_kind: str = "virtual") -> "SimCosts":
        """Every working iteration costs exactly ``dt`` — the
        ``drive_virtual`` twin used by the simcheck gate."""
        if dt <= 0:
            raise ValueError(f"tick must be positive, got {dt}")
        return cls(
            device_kind=device_kind,
            prefill_s={},
            decode_s=dt,
            tick_s=dt,
            source=f"fixed tick ({dt}s/iteration, drive_virtual twin)",
        )

    @classmethod
    def from_roofline(
        cls,
        cfg,
        *,
        buckets: Sequence[int],
        slots: int = 4,
        decode_context: Optional[int] = None,
        chip=None,
        device_kind: Optional[str] = None,
        kv_swap_in_s: float = 0.0,
        handoff_per_block_s: float = 0.0,
    ) -> "SimCosts":
        """Price steps with the serving roofline (``ServingFlops``) for
        a TransformerConfig-shaped ``cfg`` — the same model the engine
        registers as the PREDICT side of every ledger pair. The decode
        step is fixed-shape: all ``slots`` lanes attend to
        ``decode_context`` positions each (default: half the largest
        bucket, a steady-state midpoint)."""
        from ..obs.capacity import ServingFlops

        fm = ServingFlops.from_config(cfg, chip=chip)
        ctx = decode_context if decode_context is not None else max(buckets) // 2
        ctx_sum = max(1, slots) * max(1, ctx)
        decode_s = fm.roofline_s(
            fm.decode_flops(slots, ctx_sum), fm.decode_bytes(slots, ctx_sum)
        )
        return cls(
            device_kind=device_kind or f"chip:{fm.chip.name}",
            prefill_s={
                int(b): fm.roofline_s(fm.prefill_flops(b), fm.prefill_bytes(b))
                for b in buckets
            },
            decode_s=decode_s,
            verify_s=decode_s,
            kv_swap_in_s=kv_swap_in_s,
            handoff_per_block_s=handoff_per_block_s,
            source="serving roofline (ServingFlops x chip peak)",
        )

    @classmethod
    def from_strategy(
        cls,
        cfg,
        *,
        tp: int,
        mesh_devices: int,
        buckets: Sequence[int],
        slots: int = 4,
        calibration=None,
        kv_swap_in_s: float = 0.0,
        handoff_per_block_s: float = 0.0,
    ) -> "SimCosts":
        """Price steps for a tensor-parallel degree with the strategy
        search's cost plumbing (``score_serving_layouts``: graph build +
        per-op roofline + collective costs): the twin answers "what TP
        per pool" with the arithmetic the live layout chooser uses. It
        imports the search lazily and detects the device, so it belongs
        to the CLI, not the inner sim loop."""
        from ..search.serving_strategy import score_serving_layouts

        prefill_s: Dict[int, float] = {}
        decode_s = None
        for b in buckets:
            scored = score_serving_layouts(
                cfg, mesh_devices, max_batch_slots=slots,
                prefill_len=int(b), calibration=calibration,
            )
            row = next((c for c in scored if c["tp_degree"] == tp), None)
            if row is None:
                raise ValueError(
                    f"tp={tp} is not a candidate for {cfg.num_heads} heads "
                    f"over {mesh_devices} device(s) "
                    f"(candidates: {[c['tp_degree'] for c in scored]})"
                )
            prefill_s[int(b)] = float(row["prefill_s"])
            decode_s = float(row["decode_s"])
        return cls(
            device_kind=f"tp{tp}x{mesh_devices}",
            prefill_s=prefill_s,
            decode_s=decode_s,
            kv_swap_in_s=kv_swap_in_s,
            handoff_per_block_s=handoff_per_block_s,
            source=f"strategy-search cost model (tp={tp}/{mesh_devices})",
        )

    @classmethod
    def from_ledger_export(
        cls,
        export,
        *,
        model: Optional[str] = None,
        expect_device: Optional[str] = None,
        kv_swap_in_s: Optional[float] = None,
        handoff_per_block_s: float = 0.0,
    ) -> "SimCosts":
        """Build from an ``obsreport predict --export`` snapshot (path
        or parsed dict). Measured p50s win over predictions when a key
        has pairs; keys used: ``prefill[N]``, ``decode``, ``verify``,
        ``kv_swap_in``.

        ``expect_device`` refuses cross-device loads (ValueError) —
        the ``apply_recalibration`` rule: never fold one device's
        measurements into another device's table.
        """
        if isinstance(export, str):
            with open(export) as f:
                doc = json.load(f)
        else:
            doc = dict(export)
        if doc.get("schema") != "flexflow-ledger-export-v1":
            raise ValueError(
                f"not a ledger export (schema={doc.get('schema')!r}); "
                "produce one with: tools/obsreport.py predict --export FILE"
            )
        models = doc.get("models") or {}
        if not models:
            raise ValueError("ledger export contains no models")
        if model is None:
            if len(models) > 1:
                raise ValueError(
                    f"export has {sorted(models)}; pass model= to pick one"
                )
            model = next(iter(models))
        if model not in models:
            raise ValueError(f"model {model!r} not in export ({sorted(models)})")
        snap = models[model]
        device = snap.get("device_kind") or "unknown"
        if expect_device is not None and _slug(expect_device) != _slug(device):
            raise ValueError(
                f"refusing to load {device!r} measurements into a "
                f"{expect_device!r} cost table: one device's measurements "
                "are never folded into another device's table "
                "(the apply_recalibration rule)"
            )

        def seconds(entry) -> Optional[float]:
            if entry.get("pairs", 0) > 0 and entry.get("measured_p50_s") is not None:
                return float(entry["measured_p50_s"])
            if entry.get("predicted_s") is not None:
                return float(entry["predicted_s"])
            return None

        prefill_s: Dict[int, float] = {}
        decode_s = verify_s = swap_s = None
        for entry in snap.get("entries", []):
            key = entry.get("key", "")
            s = seconds(entry)
            if s is None:
                continue
            if key.startswith("prefill[") and key.endswith("]"):
                try:
                    prefill_s[int(key[len("prefill["):-1])] = s
                except ValueError:
                    continue
            elif key == "decode":
                decode_s = s
            elif key == "verify":
                verify_s = s
            elif key == "kv_swap_in":
                swap_s = s
        if not prefill_s or decode_s is None:
            raise ValueError(
                f"export for {model!r} is missing prefill[*]/decode keys "
                f"(has {[e.get('key') for e in snap.get('entries', [])]}); "
                "the engine must serve traffic before its ledger can "
                "calibrate a twin"
            )
        return cls(
            device_kind=device,
            prefill_s=prefill_s,
            decode_s=decode_s,
            verify_s=verify_s,
            kv_swap_in_s=(
                kv_swap_in_s if kv_swap_in_s is not None else (swap_s or 0.0)
            ),
            handoff_per_block_s=handoff_per_block_s,
            source=f"ledger export ({model} @ {device})",
        )
