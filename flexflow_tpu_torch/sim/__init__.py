"""Fleet digital twin: a deterministic discrete-event simulator for
the serving tier (port of ``flexflow_tpu/sim``).

The FlexFlow papers' defining move is simulator-guided optimization:
search a configuration space against a simulated execution timeline
built from a calibrated machine model, then deploy the winner. This
package applies that move to the *fleet* layer: it replays a
``tools/loadgen.py`` arrival schedule against a virtual fleet —
replicas, KV-block pools, priority queues, the AIMD limiter /
degrade ladder / autoscale advisor (the REAL control classes, run on
virtual time), and the prefill/decode pools with block handoffs
— whose per-step costs come from the calibrated serving roofline and
the PredictionLedger, never from wall clocks.

Honesty loop: a simulated scenario that also ran live registers its
latency predictions in the ledger under ``sim:`` keys, so the
drift telemetry (and the ``simcheck`` CI gate) flags a lying twin the
same way it flags a lying roofline.

Modules:

* :mod:`events`  — the DES core: virtual clock + (time, seq) event
  heap + replayable trace digest. Purely virtual time: no module of
  this package reads a real clock.
* :mod:`costs`   — where step durations come from: a ledger export
  (``tools/obsreport.py predict --export``, cross-device loads
  refused), the serving roofline, or a fixed per-iteration tick that
  mirrors ``loadgen.drive_virtual`` for sim-vs-live gating.
* :mod:`virtual` — the virtual fleet: replicas that mirror the
  continuous-batching scheduler's iteration shape and reuse the real
  ``OverloadController`` / ``AutoscaleAdvisor``.
* :mod:`report`  — per-run percentiles/goodput/shed report + the
  ``sim:`` ledger registration.
* :mod:`sweep`   — scenario sweeps with ranked configurations.
"""
from .costs import SimCosts
from .events import EventLoop, SimClock
from .report import SimReport
from .sweep import Scenario, run_scenario, scale_schedule, sweep
from .virtual import SimRequest, VirtualFleet, VirtualReplica

__all__ = [
    "EventLoop",
    "SimClock",
    "SimCosts",
    "SimReport",
    "SimRequest",
    "Scenario",
    "VirtualFleet",
    "VirtualReplica",
    "run_scenario",
    "scale_schedule",
    "sweep",
]
