"""The virtual fleet: replicas that mirror the continuous-batching
scheduler's iteration shape, driven by the discrete-event loop.

Fidelity choices, in order of importance:

* **The control plane is real, not modeled.** Each virtual replica
  instantiates the actual :class:`~flexflow_tpu_torch.serving.overload.
  OverloadController` (AIMD limiter + degrade ladder) on the sim
  clock, fed by the same signal shapes the live scheduler wires in
  (queue depth, rolling queue-time/TTFT p95 windows from
  ``serving.stats.LatencyWindow``, KV-pool pressure, the roofline TTFT
  predictor). Threshold sweeps therefore exercise the exact code that
  will run in production, at virtual speed.
* **The iteration mirrors ``_step_impl``**: expire, then admit as many
  queued requests as fit this iteration (each admission is one
  prefill, and the prefill emits the first token), then ONE decode
  step that emits one token for every active stream — including the
  just-admitted ones, which is why a unified replica's TTFT couples to
  its decode cost and a dedicated prefill replica's does not (the
  disaggregated win the twin must reproduce).
* **Two time models** (:class:`~flexflow_tpu_torch.sim.costs.SimCosts`):
  cost mode prices each iteration from the table and runs replicas as
  busy/idle event chains; tick mode replays ``loadgen.drive_virtual``
  exactly — one iteration per fixed ``dt`` with effects stamped at the
  tick — so the simcheck gate compares like with like. Tick mode also
  models the live scheduler's overlapped decode (on by
  default): steady-state iterations keep one decode step in flight
  (dispatch N+1, consume N), so the first iteration after any drain
  event — an admission, a finish, an expiry — is a refill bubble that
  emits no tokens, and the drain iteration itself consumes the
  in-flight step on top of its sequential decode. Without this the
  twin services ~20% faster than the engine it claims to mirror and
  the simcheck divergence gate catches it.

Simplifications (documented, not hidden): deadline expiry covers
queued requests only (the live reaper also kills running streams);
speculation is not simulated (ladder levels 1-2 are QoS no-ops here);
KV blocks are reserved conservatively for prompt + max_new at
admission, the scheduler's worst-case envelope.
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..serving.overload import (
    AutoscaleAdvisor,
    OverloadConfig,
    OverloadController,
    Priority,
)
from ..serving.stats import LatencyWindow
from .costs import SimCosts
from .events import EventLoop

# free-fraction floor below which the virtual KV pool reads as "under
# pressure" — obs.capacity.CacheTelemetry's default pressure_threshold
CACHE_PRESSURE_FRAC = 0.10


class SimRequest:
    """One simulated request: the arrival spec plus its lifecycle
    timestamps. ``outcome`` lands in {completed, shed, expired,
    failed}; a shed also records which gate refused it."""

    __slots__ = (
        "rid", "seq", "t", "priority", "prompt_len", "max_new",
        "deadline_s", "t_submit", "t_first_token", "t_finish", "tokens",
        "blocks", "outcome", "shed_reason", "replica", "decode_replica",
    )

    def __init__(self, *, rid: str, seq: int, t: float, priority: str,
                 prompt_len: int, max_new: int,
                 deadline_s: Optional[float] = None):
        self.rid = rid
        self.seq = seq
        self.t = float(t)
        self.priority = Priority.parse(priority)
        self.prompt_len = int(prompt_len)
        self.max_new = max(1, int(max_new))
        self.deadline_s = deadline_s
        self.t_submit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self.tokens = 0
        self.blocks = 0
        self.outcome: Optional[str] = None
        self.shed_reason: Optional[str] = None
        self.replica: Optional[str] = None
        self.decode_replica: Optional[str] = None

    @classmethod
    def from_arrival(cls, a, seq: int) -> "SimRequest":
        """Adapt a ``tools/loadgen.py`` Arrival (or any mapping /
        object with t, priority, prompt|prompt_len, max_new,
        deadline_s) without importing the tools package."""
        get = (lambda k, d=None: a.get(k, d)) if isinstance(a, dict) \
            else (lambda k, d=None: getattr(a, k, d))
        prompt = get("prompt")
        prompt_len = len(prompt) if prompt is not None else int(get("prompt_len", 1))
        return cls(
            rid=f"sim-{seq}", seq=seq, t=float(get("t", 0.0)),
            priority=get("priority", Priority.STANDARD),
            prompt_len=prompt_len, max_new=int(get("max_new", 1)),
            deadline_s=get("deadline_s"),
        )

    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit

    def tpot_s(self) -> Optional[float]:
        if (self.t_finish is None or self.t_first_token is None
                or self.tokens <= 1):
            return None
        return (self.t_finish - self.t_first_token) / (self.tokens - 1)


class BlockPool:
    """The virtual KV-block pool: conservative whole-request
    reservations against a fixed block budget, with the cache-pressure
    read the limiter consumes."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = max(1, int(num_blocks))
        self.block_size = max(1, int(block_size))
        self.used = 0

    def blocks_for(self, tokens: int) -> int:
        return max(1, -(-max(1, tokens) // self.block_size))

    def can_alloc(self, n: int) -> bool:
        return self.used + n <= self.num_blocks

    def alloc(self, n: int) -> None:
        if not self.can_alloc(n):
            raise RuntimeError(
                f"virtual block pool overcommitted ({self.used}+{n} > "
                f"{self.num_blocks})"
            )
        self.used += n

    def free(self, n: int) -> None:
        self.used = max(0, self.used - n)

    @property
    def free_fraction(self) -> float:
        return 1.0 - self.used / self.num_blocks

    @property
    def under_pressure(self) -> bool:
        return self.free_fraction <= CACHE_PRESSURE_FRAC


class VirtualReplica:
    """One replica of the twin. ``role`` is "unified" (admit +
    decode), "prefill" (admit, emit first token, hand off), or
    "decode" (adopt handed-off streams, decode only)."""

    def __init__(
        self,
        name: str,
        *,
        loop: EventLoop,
        costs: SimCosts,
        slots: int,
        max_queue: int,
        num_blocks: int,
        block_size: int = 8,
        role: str = "unified",
        index: int = 0,
        overload: Optional[OverloadConfig] = None,
        handoff_sink: Optional[Callable] = None,
        on_terminal: Optional[Callable] = None,
    ):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self.name = name
        self.loop = loop
        self.costs = costs
        self.slots = max(1, int(slots))
        self.role = role
        self.index = index
        self.pool = BlockPool(num_blocks, block_size)
        self.queue: List[Tuple[int, int, SimRequest]] = []
        self.imported: deque = deque()
        self.running: List[SimRequest] = []
        self.handoff_sink = handoff_sink
        self.on_terminal = on_terminal or (lambda req: None)
        self._busy = False
        # tick mode's overlap-pipeline frontier: the decode step that
        # has been dispatched but not yet consumed (None = drained)
        self._pipe: Optional[List[SimRequest]] = None
        self.iterations = 0
        self._queue_w = LatencyWindow(512)
        self._ttft_w = LatencyWindow(512)
        self.ctl = OverloadController(
            clock=loop.clock,
            slots=self.slots,
            max_queue=max_queue,
            queue_depth=lambda: len(self.queue) + len(self.imported),
            queue_p95=lambda: self._queue_w.snapshot()["p95_s"],
            ttft_p95=lambda: self._ttft_w.snapshot()["p95_s"],
            cache_pressure=lambda: self.pool.under_pressure,
            # the live scheduler's roofline TTFT predictor shape:
            # (queue ahead + me) prefills back to back
            ttft_predictor=lambda n, depth: (depth + 1) * costs.prefill(n),
            config=overload,
        )

    # ------------------------------------------------------------- routing
    def load(self) -> int:
        return self.ctl.limiter.inflight

    def would_admit(self, priority: str) -> bool:
        return self.ctl.would_admit(priority)

    # -------------------------------------------------------------- submit
    def submit(self, req: SimRequest, now: float) -> bool:
        """Mirror of ``ContinuousBatchingScheduler.submit``'s overload
        gate order: degraded refusal, roofline infeasibility,
        queue-full displacement, AIMD limiter, then enqueue."""
        ctl = self.ctl
        req.t_submit = now
        req.replica = self.name
        if ctl.degraded_reject(req.priority):
            return self._refuse(req, "degraded", now)
        if ctl.infeasible(req.prompt_len, req.deadline_s) is not None:
            ctl.note_rejection("infeasible", req.priority)
            req.outcome = "shed"
            req.shed_reason = "infeasible"
            req.t_finish = now
            return False
        if self.pool.blocks_for(req.prompt_len + req.max_new) > self.pool.num_blocks:
            # can never fit this pool, no matter how long it waits
            ctl.note_rejection("infeasible", req.priority)
            req.outcome = "shed"
            req.shed_reason = "infeasible"
            req.t_finish = now
            return False
        if len(self.queue) >= ctl.max_queue:
            victim = self._displacement_victim(req)
            if victim is not None and ctl.limiter.can_admit(req.priority, freed=1):
                self._shed_queued(victim, now, reason="queue_full")
            else:
                return self._refuse(req, "queue_full", now)
        if not ctl.limiter.try_acquire(req.priority):
            ctl.note_rejection("limiter", req.priority)
            req.outcome = "shed"
            req.shed_reason = "limiter"
            req.t_finish = now
            return False
        cap = ctl.max_new_cap(req.priority)
        if cap is not None:
            req.max_new = max(1, min(req.max_new, cap))
        bisect.insort(self.queue, (Priority.rank(req.priority), req.seq, req))
        if self.costs.tick_s is None:
            self._kick()
        return True

    def _refuse(self, req: SimRequest, reason: str, now: float) -> bool:
        self.ctl.note_rejection(reason, req.priority)
        req.outcome = "shed"
        req.shed_reason = reason
        req.t_finish = now
        return False

    def _displacement_victim(self, req: SimRequest) -> Optional[SimRequest]:
        """The youngest queued request of the lowest class strictly
        below the newcomer's, else None (spill/refuse instead)."""
        rank = Priority.rank(req.priority)
        best = None
        for r, seq, queued in self.queue:
            if r > rank and (best is None or (r, seq) > best[:2]):
                best = (r, seq, queued)
        return best[2] if best else None

    def _shed_queued(self, victim: SimRequest, now: float,
                     reason: str) -> None:
        self.queue = [e for e in self.queue if e[2] is not victim]
        self.ctl.note_rejection(reason, victim.priority, shed=True)
        self.ctl.limiter.release()
        victim.outcome = "shed"
        victim.shed_reason = reason
        victim.t_finish = now
        self.on_terminal(victim)

    def adopt(self, req: SimRequest, now: float) -> None:
        """Disaggregated handoff delivery: the stream was admitted (and
        emitted its first token) on a prefill replica; its load joins
        this pool forcibly, the live fleet-adopt rule."""
        req.decode_replica = self.name
        self.ctl.limiter.acquire_forced()
        self.imported.append(req)
        if self.costs.tick_s is None:
            self._kick()

    # ----------------------------------------------------------- iteration
    def expire_queued(self, now: float) -> None:
        keep = []
        for entry in self.queue:
            req = entry[2]
            if (req.deadline_s is not None
                    and now - req.t_submit >= req.deadline_s):
                self.ctl.limiter.release()
                req.outcome = "expired"
                req.t_finish = now
                self.on_terminal(req)
            else:
                keep.append(entry)
        self.queue = keep

    def _plan(self, now: float):
        """One iteration's work: returns (cost_s, admits, imported,
        decoders) or None when idle. Mutates queue/pool at plan time —
        the reservation happens when the iteration starts."""
        self.expire_queued(now)
        admits: List[SimRequest] = []
        cost = 0.0
        while (self.role != "decode" and self.queue
               and len(self.running) + len(admits) < self.slots):
            _, _, req = self.queue[0]
            need = self.pool.blocks_for(req.prompt_len + req.max_new)
            if not self.pool.can_alloc(need):
                break  # head-of-line: the live admit loop stops here too
            self.queue.pop(0)
            self.pool.alloc(need)
            req.blocks = need
            admits.append(req)
            cost += self.costs.prefill(req.prompt_len)
        imported: List[SimRequest] = []
        while (self.role == "decode" and self.imported
               and len(self.running) + len(imported) < self.slots):
            req = self.imported[0]
            need = self.pool.blocks_for(req.prompt_len + req.max_new)
            if not self.pool.can_alloc(need):
                break
            self.imported.popleft()
            self.pool.alloc(need)
            req.blocks = need
            imported.append(req)
            cost += self.costs.kv_swap_in_s
        decoders: List[SimRequest] = []
        if self.role != "prefill":
            decoders = (
                self.running
                + [a for a in admits if a.max_new > 1]
                + imported
            )
            if decoders:
                cost += self.costs.decode_s
        if not admits and not imported and not decoders:
            return None
        if self.costs.tick_s is not None:
            cost = self.costs.tick_s
        self.iterations += 1
        return cost, admits, imported, decoders

    def _apply(self, admits, imported, decoders, teff: float) -> None:
        """Iteration effects at ``teff``: first tokens for admissions
        (prefill emits the first token), handoffs for a prefill
        replica, one decode token per active stream, finishes."""
        for req in admits:
            self._queue_w.record(max(0.0, teff - req.t_submit))
            req.t_first_token = teff
            req.tokens = 1
            self._ttft_w.record(max(0.0, teff - req.t_submit))
            if self.role == "prefill":
                # stream leaves this replica: blocks travel with the
                # handoff payload, the limiter slot frees at send
                self.pool.free(req.blocks)
                self.ctl.limiter.release()
                if self.handoff_sink is not None:
                    self.handoff_sink(req, teff)
                else:
                    self._finish(req, teff)
            elif req.max_new <= 1:
                self._finish(req, teff)
        survivors: List[SimRequest] = []
        for req in decoders:
            req.tokens += 1
            if req.tokens >= req.max_new:
                self._finish(req, teff)
            else:
                survivors.append(req)
        self.running = survivors

    def _finish(self, req: SimRequest, teff: float) -> None:
        req.t_finish = teff
        req.outcome = "completed"
        self.pool.free(req.blocks)
        req.blocks = 0
        self.ctl.limiter.release()
        self.on_terminal(req)

    # cost mode: busy/idle event chain -----------------------------------
    def _kick(self) -> None:
        if self._busy:
            return
        now = self.loop.clock()
        plan = self._plan(now)
        if plan is None:
            return
        cost, admits, imported, decoders = plan
        self._busy = True
        self._control_tick(now)

        def done(t: float) -> None:
            self._apply(admits, imported, decoders, t)
            self._busy = False
            self._kick()

        self.loop.after(max(cost, 1e-9), "iter", done, detail=self.name)

    # tick mode: one synchronous iteration per fleet tick ----------------
    def step_once(self, now: float) -> None:
        """``drive_virtual`` twin: all iteration effects land at the
        tick instant (the live virtual-clock drive performs the whole
        scheduler step before advancing the clock), and the control
        plane ticks on every step call, working or idle — exactly
        ``_step_impl``'s epilogue.

        Mirrors the overlapped-decode cadence: a non-steady iteration
        (possible admission, queue expiry) drains the in-flight step —
        its tokens ride this iteration — then runs the sequential body
        (admit + one decode); a steady iteration dispatches the next
        step and consumes the previous one, which after a drain means
        a refill bubble that emits nothing."""
        if self._nonsteady_tick(now):
            prev, self._pipe = self._pipe, None
            if prev:
                self._consume(prev, now)
            plan = self._plan(now)
            if plan is not None:
                _, admits, imported, decoders = plan
                self._apply(admits, imported, decoders, now)
        else:
            # steady state: dispatch step N+1 over the slots still
            # under budget (a slot with its pipelined token pending at
            # max_new is excluded — the live budget-predicted finish),
            # then consume step N
            prev = self._pipe
            covered = set(id(r) for r in prev) if prev else set()
            live = [
                r for r in self.running
                if r.tokens + (1 if id(r) in covered else 0) < r.max_new
            ]
            self._pipe = live or None
            if prev:
                self._consume(prev, now)
            if prev or live:
                self.iterations += 1
        self._control_tick(now)

    def _nonsteady_tick(self, now: float) -> bool:
        """Tick-mode mirror of ``_step_impl._nonsteady``: the iteration
        must run the sequential path when an admission could place
        (backlog + a free slot) or a queued deadline has passed. The
        live reaper's running-stream expiry is not simulated
        (documented simplification)."""
        for _, _, req in self.queue:
            if (req.deadline_s is not None
                    and now - req.t_submit >= req.deadline_s):
                return True
        backlog = self.imported if self.role == "decode" else self.queue
        return bool(backlog) and len(self.running) < self.slots

    def _control_tick(self, now: float) -> None:
        """``_overload_tick``'s twin: limiter AIMD + ladder fold, plus
        the ladder's level-4 action — shed every queued best-effort
        request (never-streamed work only; in the sim all queued work
        is never-streamed)."""
        self.ctl.tick()
        if self.ctl.ladder.shed_best_effort():
            victims = [
                e[2] for e in self.queue
                if e[2].priority == Priority.BEST_EFFORT
            ]
            for v in victims:
                self._shed_queued(v, now, reason="degraded")

    def _consume(self, entries: List[SimRequest], now: float) -> None:
        """Consume one in-flight pipelined decode step: a token for
        every covered stream, finishes at budget."""
        covered = set(id(r) for r in entries)
        survivors: List[SimRequest] = []
        for req in self.running:
            if id(req) in covered:
                req.tokens += 1
                if req.tokens >= req.max_new:
                    self._finish(req, now)
                    continue
            survivors.append(req)
        self.running = survivors

    def idle_control_tick(self, now: float) -> None:
        """Cost-mode housekeeping between iterations (fleet poll): an
        idle replica's limiter still probes upward and its ladder still
        descends — the live scheduler loop spins and ticks even with
        no work."""
        if not self._busy:
            self.expire_queued(now)
            self._control_tick(now)

    def activations(self) -> Dict:
        out = self.ctl.activations()
        out["iterations"] = self.iterations
        out["max_degrade_level"] = self.ctl.ladder.max_level_seen
        return out


class VirtualFleet:
    """A fleet of virtual replicas plus the real autoscale advisor.

    ``arm="unified"`` builds ``replicas`` interchangeable replicas;
    ``arm="disagg"`` builds a prefill pool and a decode pool joined by
    a handoff wire priced per block (the disaggregated shape: TTFT is decided at
    the prefill replica, TPOT at the decode replica, and the transfer
    sits between first and second token).
    """

    def __init__(
        self,
        *,
        loop: EventLoop,
        costs: SimCosts,
        arm: str = "unified",
        replicas: int = 2,
        n_prefill: int = 1,
        n_decode: int = 1,
        slots: int = 4,
        max_queue: int = 16,
        num_blocks: int = 64,
        block_size: int = 8,
        overload: Optional[OverloadConfig] = None,
        poll_s: float = 0.05,
        name: str = "sim",
    ):
        if arm not in ("unified", "disagg"):
            raise ValueError(f"unknown arm {arm!r}")
        self.loop = loop
        self.costs = costs
        self.arm = arm
        self.name = name
        self.poll_s = float(poll_s)
        self.overload_cfg = overload or OverloadConfig()
        self.outstanding = 0
        self.terminal: List[SimRequest] = []
        self.more_arrivals: Callable[[], bool] = lambda: False
        self.autoscale = AutoscaleAdvisor.from_config(
            self.overload_cfg, clock=loop.clock
        )
        self.autoscale_timeline: List[Tuple[float, int, float, float]] = []

        def mk(role: str, i: int) -> VirtualReplica:
            return VirtualReplica(
                f"{name}-{role[0]}{i}", loop=loop, costs=costs, slots=slots,
                max_queue=max_queue, num_blocks=num_blocks,
                block_size=block_size, role=role, index=i,
                overload=self.overload_cfg,
                handoff_sink=self._handoff if role == "prefill" else None,
                on_terminal=self._terminal,
            )

        if arm == "unified":
            self.replicas = [mk("unified", i) for i in range(max(1, replicas))]
            self.prefill_pool = self.replicas
            self.decode_pool: List[VirtualReplica] = []
        else:
            self.prefill_pool = [mk("prefill", i) for i in range(max(1, n_prefill))]
            self.decode_pool = [mk("decode", i) for i in range(max(1, n_decode))]
            self.replicas = self.prefill_pool + self.decode_pool

    # -------------------------------------------------------------- traffic
    def submit(self, req: SimRequest, now: float) -> bool:
        """Route like the fleet router: prefer replicas whose overload
        gates would admit, least-loaded first; with nowhere to spill,
        the least-loaded replica's own gates shed (the fleet-wide
        shed)."""
        pool = self.prefill_pool
        cands = [r for r in pool if r.would_admit(req.priority)] or pool
        rep = min(cands, key=lambda r: (r.load(), r.index))
        ok = rep.submit(req, now)
        if ok:
            self.outstanding += 1
        return ok

    def _terminal(self, req: SimRequest) -> None:
        self.outstanding -= 1
        self.terminal.append(req)

    def _handoff(self, req: SimRequest, t: float) -> None:
        """Prefill -> decode block transfer: priced per block, then
        adopted by the least-loaded decode replica."""
        delay = self.costs.handoff_s(req.blocks)

        def deliver(tt: float) -> None:
            rep = min(self.decode_pool, key=lambda r: (r.load(), r.index))
            rep.adopt(req, tt)

        self.loop.after(delay, "handoff", deliver, detail=req.rid)

    # -------------------------------------------------------- control plane
    def start_polling(self) -> None:
        """Begin the fleet supervisor twin: one autoscale observation
        (and cost-mode idle control tick) every ``poll_s`` of virtual
        time, self-terminating when traffic drains."""
        self.loop.at(self.loop.clock(), "poll", self._poll, detail=self.name)

    def _poll(self, t: float) -> None:
        eligible = self.replicas
        if not eligible:
            sat, util = 1.0, 1.0
        else:
            saturated = 0
            util = 0.0
            for r in eligible:
                util += r.ctl.limiter.utilization()
                if (not r.ctl.would_admit(Priority.STANDARD)
                        or r.ctl.ladder.level >= 1):
                    saturated += 1
            sat = saturated / len(eligible)
            util /= len(eligible)
        sig = self.autoscale.observe(sat, util)
        self.autoscale_timeline.append(
            (round(t, 9), sig, round(sat, 6), round(util, 6))
        )
        if self.costs.tick_s is None:
            for r in self.replicas:
                r.idle_control_tick(t)
        if self.outstanding > 0 or self.more_arrivals():
            self.loop.after(self.poll_s, "poll", self._poll, detail=self.name)

    def step_all(self, now: float) -> None:
        """Tick mode: one synchronous iteration per replica per tick
        (prefill pool first, so same-tick handoffs are in flight before
        the decode pool steps)."""
        for r in self.prefill_pool:
            r.step_once(now)
        for r in self.decode_pool:
            r.step_once(now)

    # ------------------------------------------------------------ reporting
    def engines(self) -> int:
        return len(self.replicas)

    def activations(self) -> Dict:
        per = {r.name: r.activations() for r in self.replicas}
        agg: Dict[str, int] = {}
        for acts in per.values():
            for k, v in acts.items():
                if k == "degrade_level":
                    continue
                if k == "max_degrade_level":
                    agg[k] = max(agg.get(k, 0), int(v))
                else:
                    agg[k] = agg.get(k, 0) + int(v)
        return {"total": agg, "per_replica": per}

    def autoscale_summary(self) -> Dict:
        signals = [s for _, s, _, _ in self.autoscale_timeline]
        changes = sum(
            1 for a, b in zip(signals, signals[1:]) if a != b
        )
        # a flap is a direct want-more <-> want-fewer reversal with no
        # settled (0) observation between — the hysteresis test pins 0
        flaps = sum(
            1 for a, b in zip(signals, signals[1:])
            if a != 0 and b != 0 and a != b
        )
        return {
            "observations": len(signals),
            "max_signal": max(signals) if signals else 0,
            "min_signal": min(signals) if signals else 0,
            "signal_changes": changes,
            "flaps": flaps,
            "timeline": [
                {"t": t, "signal": s, "saturated_frac": f, "mean_util": u}
                for t, s, f, u in self.autoscale_timeline
            ],
        }
