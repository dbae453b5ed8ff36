"""Serving observability of the port (port of parts of ``flexflow_tpu/obs``)."""
from .capacity import CHIP_PRESETS, ChipSpec, ServingFlops, chip_spec_for

__all__ = ["CHIP_PRESETS", "ChipSpec", "ServingFlops", "chip_spec_for"]
