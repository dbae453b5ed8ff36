"""The serving FLOPs and bytes model and its roofline (port of
``ServingFlops`` from ``flexflow_tpu/obs/capacity.py``), as far as the
prefix cache's swap-in-or-recompute decision needs it
(:meth:`~flexflow_tpu_torch.generation.engine.GenerationEngine.prefix_plan`).

The derates are the JAX package's search cost model's
(``flexflow_tpu/search/cost_model.py``), copied so the two engines take
the same decisions from the same sizes. The chip presets: ``cpu`` holds
the JAX package's nominal CPU peaks (so the port's CPU engine decides as
the JAX CPU engine does), ``h100`` the H100 SXM's datasheet figures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# utilization derates: achievable fraction of peak (the JAX search cost
# model's constants)
MXU_EFFICIENCY = 0.55
HBM_EFFICIENCY = 0.8
KERNEL_OVERHEAD = 2e-6  # fixed per-step launch overhead (s)


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one device, for the serving roofline."""

    name: str
    f32_flops: float  # FLOP/s
    hbm_bandwidth: float  # bytes/s
    hbm_capacity: float  # bytes


CHIP_PRESETS = {
    # the JAX package's nominal CPU peaks (its calibration preset "cpu")
    "cpu": ChipSpec(name="cpu", f32_flops=1e11, hbm_bandwidth=2e10, hbm_capacity=16e9),
    # datasheet figures, H100 SXM: fp32 on the CUDA cores, the rate the
    # port's GEMMs run at (fp32, TF32 off)
    "h100": ChipSpec(name="h100", f32_flops=67e12, hbm_bandwidth=3.35e12, hbm_capacity=80e9),
}


def chip_spec_for(device: torch.device) -> ChipSpec:
    """The preset for the engine's device: ``cpu`` for the CPU, ``h100``
    for a CUDA device (the card the port is built for)."""
    return CHIP_PRESETS["cpu" if device.type == "cpu" else "h100"]


class ServingFlops:
    """Analytic per-step FLOPs and HBM bytes of the generation engine's
    steps, folded into per-token and per-context-position constants, for
    fp32 weights and cache (the port's float dtype) at the chip's fp32
    rate.

    Per useful token (matmuls only, forward):
      qkv + out projections  8 * E^2          per layer
      FFN (two matmuls)      4 * E * F        per layer
      LM head                2 * E * V        once
    Per (token, live context position):
      QK^T + AV              4 * E            per layer
    """

    def __init__(
        self,
        num_layers: int,
        hidden_size: int,
        ff_size: int,
        vocab_size: int,
        chip: Optional[ChipSpec] = None,
    ):
        e, f, l, v = hidden_size, ff_size, num_layers, vocab_size
        self.per_token_flops = l * (8 * e * e + 4 * e * f) + 2 * e * v
        self.per_ctx_flops = l * 4 * e
        self.chip = chip or CHIP_PRESETS["h100"]
        self.peak_flops = self.chip.f32_flops
        # each step streams the weights once and touches the KV cache per
        # live context position
        self.dtype_bytes = 4
        self.param_count = 2 * v * e + l * (4 * e * e + 2 * e * f)
        self.param_bytes = self.param_count * self.dtype_bytes
        self.kv_bytes_per_pos = 2 * l * e * self.dtype_bytes  # k + v

    @classmethod
    def from_config(cls, cfg, chip: Optional[ChipSpec] = None) -> "ServingFlops":
        """Build from a TransformerConfig (the engine's ``cfg``)."""
        return cls(
            num_layers=cfg.num_layers,
            hidden_size=cfg.hidden_size,
            ff_size=cfg.ff_size,
            vocab_size=cfg.vocab_size,
            chip=chip,
        )

    def prefill_flops(self, prompt_len: int) -> float:
        """One prompt of ``prompt_len`` true tokens; causal context sum
        n(n+1)/2."""
        n = max(0, prompt_len)
        return n * self.per_token_flops + self.per_ctx_flops * (n * (n + 1) // 2)

    def decode_flops(self, n_active: int, context_sum: int) -> float:
        """One decode step: ``n_active`` live tokens attending to
        ``context_sum`` live context positions in all."""
        return n_active * self.per_token_flops + self.per_ctx_flops * context_sum

    def verify_flops(self, n_tokens: int, context_sum: int) -> float:
        """One verify (or suffix prefill) step: ``n_tokens`` live window
        tokens attending to ``context_sum`` live positions in all."""
        return n_tokens * self.per_token_flops + self.per_ctx_flops * context_sum

    def prefill_bytes(self, prompt_len: int) -> float:
        n = max(0, prompt_len)
        return self.param_bytes + self.kv_bytes_per_pos * n

    def decode_bytes(self, n_active: int, context_sum: int) -> float:
        """Weights once, K/V read per live context position, K/V written
        per active token."""
        return self.param_bytes + self.kv_bytes_per_pos * (context_sum + n_active)

    def verify_bytes(self, n_tokens: int, context_sum: int) -> float:
        return self.param_bytes + self.kv_bytes_per_pos * (context_sum + n_tokens)

    def roofline_s(self, flops: float, bytes_hbm: float) -> float:
        """Predicted seconds of one step: the larger of the derated
        compute and memory times, plus the fixed overhead."""
        t_compute = flops / (self.peak_flops * MXU_EFFICIENCY)
        t_memory = bytes_hbm / (self.chip.hbm_bandwidth * HBM_EFFICIENCY)
        return max(t_compute, t_memory) + KERNEL_OVERHEAD
