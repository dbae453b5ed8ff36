"""flexlint policy for the port: which files are exempt from which rule,
and why (port of ``flexflow_tpu/analysis/config.py``).

This file is the reviewed, centralized counterpart to inline
``# flexlint: disable=`` comments: inline suppressions are for single
statements; entries here are for whole files whose PURPOSE exempts them
(a calibration harness exists to measure physical wall time). Every
entry carries its reason, so it can be re-litigated.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Union

# --------------------------------------------------------------- clocks
# Wall-clock whitelist for the clock-discipline rule. Keys are
# repo-relative paths (a trailing "/" whitelists the directory); values
# are "*" (any of time.time / time.monotonic / time.perf_counter) or
# the frozenset of allowed function names. Everything else must take an
# injectable clock so virtual-clock tests control time.
CLOCK_WHITELIST: Dict[str, Union[str, FrozenSet[str]]] = {
    # Offline bench/diagnostic harnesses and the card probes: measuring
    # physical wall time is their job, and their watchdog waits bound
    # real blocking calls.
    "flexflow_tpu_torch/tools/": "*",
    # Kernel calibration measures device wall time by definition.
    "flexflow_tpu_torch/search/calibration.py": "*",
    # The op profiler is a physical-time measurement instrument.
    "flexflow_tpu_torch/runtime/profiling.py": "*",
    # Dual-stamp decision: device-step phase DURATIONS are physical
    # profiling data (perf_counter) even in virtual-clock tests;
    # scheduler-plane timestamps still ride the injectable clock. Only
    # perf_counter is exempt — time.time/monotonic in these files is
    # still a violation.
    "flexflow_tpu_torch/generation/engine.py": frozenset({"perf_counter"}),
    "flexflow_tpu_torch/generation/scheduler.py": frozenset({"perf_counter"}),
    "flexflow_tpu_torch/runtime/executor.py": frozenset({"perf_counter"}),
    # A step graph's capture seconds (the program registry's compile
    # time on a GPU): physical profiling data, perf_counter only.
    "flexflow_tpu_torch/runtime/step_graph.py": frozenset({"perf_counter"}),
    # Grammar-compile telemetry: compile_seconds is physical profiling
    # data like the engine's phase spans — perf_counter only.
    "flexflow_tpu_torch/generation/constrained/tokens.py": frozenset({"perf_counter"}),
    # Step-anatomy profiler: perf_counter-only physical profiling per the
    # dual-clock decision — it aggregates the engine/scheduler
    # perf_counter span stamps and must never mix in the scheduler's
    # injectable (possibly virtual) clock.
    "flexflow_tpu_torch/obs/steptrace.py": frozenset({"perf_counter"}),
    # Durable WAL: fsync DURATION is physical profiling data
    # (perf_counter only). Journal-record wall stamps ride the injectable
    # wall_clock passed to WriteAheadLog.
    "flexflow_tpu_torch/runtime/wal.py": frozenset({"perf_counter"}),
    # Build timers of the CUDA kernels (nvcc) and the native library
    # (g++): how long a compile took is physical wall time.
    "flexflow_tpu_torch/ops/kernels/_build.py": frozenset({"perf_counter"}),
    "flexflow_tpu_torch/_native/__init__.py": frozenset({"perf_counter"}),
}

# Paths where clock-discipline runs in STRICT virtual-time mode: ANY
# reference to a real clock — a call, a bare name, an injectable
# default argument, even perf_counter — is a violation, and the
# whitelist above does not apply. The fleet digital twin
# (flexflow_tpu_torch/sim/) is deterministic by contract: its only time
# source is the event loop's virtual clock, and a single real stamp
# breaks byte-identical replay and the simcheck divergence gate.
CLOCK_STRICT_PATHS = ("flexflow_tpu_torch/sim/",)

# ----------------------------------------------------------- fault sites
# Files the fault-site rule does not police: the registry itself (it
# DEFINES the literals) and this analysis package (rule fixtures).
SITE_RULE_EXCLUDE = (
    "flexflow_tpu_torch/runtime/faults.py",
    "flexflow_tpu_torch/analysis/",
)

# Site literals must start with one of these segments to be treated as
# fault-site names when passed to FaultPlan.on(...) (the prefix filter
# keeps .on(...) of unrelated APIs out of this rule's jurisdiction).
SITE_PREFIXES = (
    "executor.", "elastic.", "checkpoint.", "serving.", "generation.",
    "fleet.",
)
