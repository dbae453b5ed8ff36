#!/usr/bin/env python
"""loadgen: open-loop Poisson load generator with a priority mix and a
deadline distribution, over the port's serving stack (port of the JAX
package's ``tools/loadgen.py``).

Open-loop means arrivals are scheduled by a Poisson process and
submitted at their scheduled time whether or not earlier requests
finished — the load that actually overloads a server, unlike a
closed-loop client whose offered rate collapses with latency. Each
arrival draws a priority class (interactive / standard / best_effort),
a prompt, and a deadline; the report breaks goodput, shed rate, and
TTFT out per class.

Three drive modes:

* **in-process** (default): builds a tiny engine (on the GPU; ``--device
  cpu`` for the CPU) + continuous-batching scheduler and drives the
  schedule deterministically on a VIRTUAL clock (seeded arrivals, fixed
  step dt) — the mode chaoscheck's overload storm and simfleet's live
  storm reuse via :func:`drive_virtual`.
* **--url http://host:port**: real open-loop HTTP load against a
  running server (``flexflow_tpu_torch.serving.server``): one thread per
  arrival fires a ``POST /v2/models/{name}/generate`` at its scheduled
  wall time; 503 answers count as sheds and 504 as expiries, per
  priority.
* **--disagg-ab**: the disaggregated-serving A/B — the SAME seeded
  open-loop schedule of mixed long/short prompts through a 2-replica
  unified fleet and a 1 prefill + 1 decode disaggregated fleet (equal
  engine budget), interleaved best-of-N. Per arm: TTFT p95 and decode
  TPOT p50. Gates: byte-identical streams across arms, zero steady-state
  captures on every replica engine, and both improvement ratios over
  their floors; appends a perfwatch line to the bench history.

The same seed gives the JAX tool's schedule, arrival by arrival, and
each package reads a schedule file the other wrote.

Usage:
  python -m flexflow_tpu_torch.tools.loadgen --rate 50 --duration 2 --mix 0.2,0.2,0.6
  python -m flexflow_tpu_torch.tools.loadgen --url http://127.0.0.1:8000 --model lm ...
  python -m flexflow_tpu_torch.tools.loadgen --disagg-ab --out disagg_bench.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from flexflow_tpu_torch.tools._common import Clock, backend, git_sha, out_path, pct, seeded_params

PRIORITIES = ("interactive", "standard", "best_effort")


@dataclasses.dataclass
class Arrival:
    """One scheduled request."""

    t: float                 # arrival time, seconds from schedule start
    priority: str
    prompt: List[int]
    deadline_s: Optional[float]
    max_new: int


def build_schedule(
    rate_rps: float,
    duration_s: float,
    *,
    mix: Sequence[float] = (0.2, 0.3, 0.5),
    seed: int = 0,
    vocab: int = 40,
    prompt_len_lo: int = 3,
    prompt_len_hi: int = 8,
    deadlines_s: Sequence[Optional[float]] = (None, 5.0, 30.0),
    max_new: int = 8,
) -> List[Arrival]:
    """Seeded Poisson arrival schedule: exponential inter-arrivals at
    ``rate_rps`` over ``duration_s``, priorities drawn from ``mix``
    (interactive, standard, best_effort fractions), deadlines drawn
    uniformly from ``deadlines_s`` (None = no deadline). The draws are
    the JAX tool's, call for call."""
    if abs(sum(mix) - 1.0) > 1e-6:
        raise ValueError(f"priority mix must sum to 1, got {mix}")
    rng = random.Random(f"loadgen|{seed}")
    out: List[Arrival] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        if t >= duration_s:
            return out
        r = rng.random()
        if r < mix[0]:
            priority = "interactive"
        elif r < mix[0] + mix[1]:
            priority = "standard"
        else:
            priority = "best_effort"
        n = rng.randint(prompt_len_lo, prompt_len_hi)
        prompt = [rng.randrange(1, vocab) for _ in range(n)]
        out.append(Arrival(
            t=t, priority=priority, prompt=prompt,
            deadline_s=rng.choice(list(deadlines_s)), max_new=max_new,
        ))


# ------------------------------------------------------------ schedules
SCHEDULE_SCHEMA = "flexflow-load-schedule-v1"


def save_schedule(schedule: Sequence[Arrival], path: str,
                  *, meta: Optional[Dict] = None) -> None:
    """Serialize the exact arrival schedule (timestamps, prompts,
    priorities, deadlines, max_new) so the identical workload can drive
    live runs, A/B gates, and the sim/ digital twin. ``meta`` records how
    it was built (rate, seed, ...) for provenance."""
    doc = {
        "schema": SCHEDULE_SCHEMA,
        "meta": dict(meta or {}),
        "arrivals": [dataclasses.asdict(a) for a in schedule],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def load_schedule(path: str, *, with_meta: bool = False):
    """Replay a recorded schedule deterministically. Returns the Arrival
    list (sorted by arrival time), or (arrivals, meta) with
    ``with_meta=True``."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEDULE_SCHEMA:
        raise ValueError(
            f"{path}: not a load schedule "
            f"(schema={doc.get('schema')!r}, want {SCHEDULE_SCHEMA!r})"
        )
    arrivals = [
        Arrival(
            t=float(d["t"]),
            priority=str(d["priority"]),
            prompt=[int(x) for x in d["prompt"]],
            deadline_s=(
                None if d.get("deadline_s") is None
                else float(d["deadline_s"])
            ),
            max_new=int(d["max_new"]),
        )
        for d in doc["arrivals"]
    ]
    arrivals.sort(key=lambda a: a.t)
    if with_meta:
        return arrivals, dict(doc.get("meta") or {})
    return arrivals


def resolve_schedule(args) -> List[Arrival]:
    """The CLI's schedule source: ``--schedule FILE`` replays a recording
    (and restores its recorded duration for rate math); otherwise build
    from the seeded generator, recording to ``--record-schedule FILE``
    when asked."""
    if getattr(args, "schedule", ""):
        arrivals, meta = load_schedule(args.schedule, with_meta=True)
        if meta.get("duration_s"):
            args.duration = float(meta["duration_s"])
        elif arrivals:
            args.duration = max(args.duration, arrivals[-1].t)
        return arrivals
    schedule = build_schedule(
        args.rate, args.duration, mix=args.mix_t, seed=args.seed,
        vocab=args.vocab, deadlines_s=args.deadlines_t,
        max_new=args.max_new,
    )
    if getattr(args, "record_schedule", ""):
        save_schedule(schedule, args.record_schedule, meta={
            "rate_rps": args.rate, "duration_s": args.duration,
            "mix": list(args.mix_t), "seed": args.seed,
            "vocab": args.vocab, "max_new": args.max_new,
            "deadlines_s": list(args.deadlines_t),
        })
        print(f"recorded {len(schedule)} arrivals -> "
              f"{args.record_schedule}", file=sys.stderr)
    return schedule


class LoadReport:
    """Per-priority outcome + TTFT accounting; thread-safe for the --url
    mode's per-arrival threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self.per: Dict[str, Dict] = {  # guarded-by: _lock
            p: {
                "submitted": 0, "completed": 0, "shed": 0, "expired": 0,
                "failed": 0, "tokens": 0, "good_tokens": 0, "ttft_s": [],
            }
            for p in PRIORITIES
        }
        self._streams: List = []  # (prompt, tokens) pairs; guarded-by: _lock

    def note_stream(self, prompt: List[int], tokens: List[int]) -> None:
        """Retain one completed stream for byte-exactness checks."""
        with self._lock:
            self._streams.append((list(prompt), list(tokens)))

    def streams(self) -> List:
        with self._lock:
            return list(self._streams)

    def note(self, priority: str, outcome: str, tokens: int = 0,
             good: bool = False, ttft_s: Optional[float] = None) -> None:
        with self._lock:
            d = self.per[priority]
            d["submitted"] += 1
            d[outcome] += 1
            d["tokens"] += tokens
            if good:
                d["good_tokens"] += tokens
            if ttft_s is not None:
                d["ttft_s"].append(ttft_s)

    def ttfts(self) -> Dict[str, List[float]]:
        """Each class's TTFT samples (seconds)."""
        with self._lock:
            return {p: list(d["ttft_s"]) for p, d in self.per.items()}

    def render(self, duration_s: float) -> Dict:
        with self._lock:
            per = {}
            total = {"submitted": 0, "shed": 0, "tokens": 0, "good_tokens": 0}
            for p in PRIORITIES:
                d = self.per[p]
                per[p] = {
                    k: d[k] for k in
                    ("submitted", "completed", "shed", "expired", "failed",
                     "tokens", "good_tokens")
                }
                per[p]["ttft_p50_s"] = pct(d["ttft_s"], 0.50)
                per[p]["ttft_p95_s"] = pct(d["ttft_s"], 0.95)
                for k in total:
                    total[k] += d[k]
        shed_rate = total["shed"] / total["submitted"] if total["submitted"] else 0.0
        return {
            "duration_s": duration_s,
            "submitted": total["submitted"],
            "shed_rate": shed_rate,
            "goodput_tokens_per_s": total["good_tokens"] / max(1e-9, duration_s),
            "tokens_per_s": total["tokens"] / max(1e-9, duration_s),
            "per_priority": per,
        }


# --------------------------------------------------------------- virtual
def drive_virtual(
    scheduler,
    schedule: Sequence[Arrival],
    clock,
    *,
    dt: float = 0.01,
    sampling_cls=None,
    drain_steps: int = 20000,
    on_tick: Optional[Callable[[], None]] = None,
) -> LoadReport:
    """Deterministic open-loop drive on a virtual clock (callable, with
    ``.advance(dt)``): each tick submits the arrivals now due, steps the
    scheduler once, and advances the clock by ``dt``. Used in-process and
    by chaoscheck's overload storm; returns the filled
    :class:`LoadReport` (TTFT from request traces, so observability must
    be on)."""
    from flexflow_tpu_torch.generation.engine import SamplingParams
    from flexflow_tpu_torch.serving.resilience import DeadlineExceededError, OverloadedError

    sampling_cls = sampling_cls or SamplingParams
    report = LoadReport()
    live = []  # (arrival, handle)
    i = 0
    t0 = clock()
    steps = 0
    while i < len(schedule) or any(not h.done() for _, h in live):
        now = clock() - t0
        while i < len(schedule) and schedule[i].t <= now:
            a = schedule[i]
            i += 1
            try:
                h = scheduler.submit(
                    a.prompt, sampling_cls(max_new_tokens=a.max_new),
                    deadline_s=a.deadline_s, priority=a.priority,
                )
            except OverloadedError:
                report.note(a.priority, "shed")
                continue
            except DeadlineExceededError:
                report.note(a.priority, "expired")
                continue
            live.append((a, h))
        scheduler.step()
        if on_tick is not None:
            on_tick()
        clock.advance(dt)
        steps += 1
        if steps > drain_steps:
            break
    for a, h in live:
        try:
            tokens = h.result(timeout=0)
        except OverloadedError:
            report.note(a.priority, "shed")
            continue
        except DeadlineExceededError:
            report.note(a.priority, "expired")
            continue
        except Exception:  # noqa: BLE001 - any other failure is the outcome
            report.note(a.priority, "failed")
            continue
        tr = h.trace_dict()
        report.note(
            a.priority, "completed", tokens=len(tokens), good=True,
            ttft_s=tr.get("ttft_s"),
        )
        report.note_stream(a.prompt, tokens)
    return report


def tiny_config(vocab: int, hidden: int = 32, seq_length: int = 64):
    """The in-process engine's decoder: one layer, 4 heads."""
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=1, hidden_size=hidden, num_heads=4, ff_size=2 * hidden,
        seq_length=seq_length, vocab_size=vocab, causal=True,
    )


def run_inprocess(args) -> Dict:
    """Build a tiny engine + scheduler (on ``args.device``, weights seeded
    from 0) and drive the schedule on a virtual clock (deterministic
    under --seed)."""
    from flexflow_tpu_torch.generation import ContinuousBatchingScheduler, GenerationEngine
    from flexflow_tpu_torch.serving.overload import OverloadConfig

    cfg = tiny_config(args.vocab)
    engine = GenerationEngine(
        seeded_params(cfg), cfg,
        max_batch_slots=args.slots, block_size=8, prompt_buckets=(8, 32, 64),
        device=args.device,
    )
    clock = Clock()
    sched = ContinuousBatchingScheduler(
        engine, clock=clock, max_queue=args.max_queue,
        overload=OverloadConfig(),
    )
    schedule = resolve_schedule(args)
    report = drive_virtual(sched, schedule, clock, dt=args.dt)
    sched.stop()
    out = report.render(args.duration)
    out["mode"] = "in-process (virtual clock)"
    out["overload"] = sched.overload.activations()
    return out


# ------------------------------------------------------------------ http
def run_http(args, report: Optional[LoadReport] = None) -> Dict:
    """Real open-loop HTTP load: one thread per arrival fires at its
    scheduled wall time. TTFT is approximated by response latency
    (non-streaming generate); sheds are 503 answers, expiries 504. Every
    request times out after ``args.timeout`` seconds (a hang counts as
    ``failed``); threads still running after that are reported as
    ``unfinished``. Pass ``report`` to keep the streams and TTFT samples."""
    schedule = resolve_schedule(args)
    report = report if report is not None else LoadReport()
    base = args.url.rstrip("/")
    url = f"{base}/v2/models/{args.model}/generate"
    timeout = getattr(args, "timeout", 300.0)

    def fire(a: Arrival):
        body = {
            "prompt": a.prompt, "max_new_tokens": a.max_new,
            "priority": a.priority,
        }
        if a.deadline_s is not None:
            body["parameters"] = {"timeout_ms": int(a.deadline_s * 1000)}
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                resp = json.loads(r.read())
            report.note(
                a.priority, "completed", tokens=resp.get("num_generated", 0),
                good=True, ttft_s=time.monotonic() - t0,
            )
            report.note_stream(a.prompt, resp.get("tokens", []))
        except urllib.error.HTTPError as e:
            if e.code == 503:
                report.note(a.priority, "shed")
            elif e.code == 504:
                report.note(a.priority, "expired")
            else:
                report.note(a.priority, "failed")
        except Exception:  # noqa: BLE001 - a broken connection is a failed request
            report.note(a.priority, "failed")

    threads = []
    t0 = time.monotonic()
    for a in schedule:
        delay = a.t - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=fire, args=(a,), daemon=True)
        th.start()
        threads.append(th)
    deadline = time.monotonic() + timeout + 30.0
    for th in threads:
        th.join(timeout=max(0.0, deadline - time.monotonic()))
    out = report.render(args.duration)
    out["mode"] = f"http ({base})"
    out["unfinished"] = sum(th.is_alive() for th in threads)
    return out


# ------------------------------------------------------------ disagg A/B
def _append_ab_history(path: str, report: Dict, device) -> None:
    """One perfwatch-schema line (same shape as genbench's
    append_history): timestamped, git-sha-stamped, ok-flagged so a run
    that failed its own gate never enters the rolling baseline."""
    if not path:
        return
    entry = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "git_sha": git_sha(),
        "backend": backend(device),
        "mode": "disagg_ab",
        "ok": bool(report.get("ok")),
        "metrics": {
            "disagg_ttft_p95_ratio": report.get("ttft_p95_ratio"),
            "disagg_tpot_p50_ratio": report.get("tpot_p50_ratio"),
            "disagg_ttft_p95_s": (report.get("disagg") or {}).get("ttft_p95_s"),
        },
    }
    try:
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as e:
        print(f"WARNING: could not append bench history to {path}: {e}",
              file=sys.stderr)


def run_disagg_ab(args) -> Dict:
    """Unified vs disaggregated A/B on live fleets (real clock, real
    threads — the contention being measured IS wall time: prefills
    interleaving into a unified replica's decode loop). Both arms get the
    same engine budget (two engines), the same seeded schedule, and fully
    pre-warmed replicas, so the measured phase is steady state and the
    only difference is pool specialization. The replicas' decoder is the
    JAX tool's 1 x 64 config, weights seeded from 0."""
    from flexflow_tpu_torch.generation import GenerationEngine, SamplingParams
    from flexflow_tpu_torch.serving.fleet import DisaggregatedFleet, Fleet

    buckets = (8, 128)
    cfg = tiny_config(args.vocab, hidden=64, seq_length=160)
    params = seeded_params(cfg, device=args.device)

    def make_engine():
        # prefix_cache off (genbench's bench idiom): radix reuse would
        # vary prefill suffix shapes, which is capture noise, not the
        # A/B's contention
        return GenerationEngine(
            params, cfg, max_batch_slots=args.slots, block_size=8,
            prompt_buckets=buckets, prefix_cache=False, device=args.device,
        )

    # mixed long/short prompts (3..120 tokens spans both buckets), all
    # standard priority, no deadlines: every arrival must COMPLETE in
    # both arms or the byte-exactness comparison is meaningless
    schedule = build_schedule(
        args.rate, args.duration, mix=(0.0, 1.0, 0.0), seed=args.seed,
        vocab=args.vocab, prompt_len_lo=3, prompt_len_hi=120,
        deadlines_s=(None,), max_new=args.max_new,
    )
    sk = dict(max_queue=max(256, args.max_queue))

    def run_arm(gen):
        """Drive the schedule open-loop; returns (results, captures) with
        results = [(arrival, tokens|None, ttft_s, total_s)]."""
        reps = list(gen.replicas)
        # steady state: capture every prompt bucket + the decode step on
        # every replica engine BEFORE the measured phase
        for r in reps:
            for b in buckets:
                n = min(b, cfg.seq_length - args.max_new - 2)
                r.engine.generate([[1] * n], SamplingParams(max_new_tokens=2))
        warm = [dict(r.engine.trace_counts) for r in reps]
        gen.start()
        results, lock, threads = [], threading.Lock(), []

        def waiter(a, h, t_sub):
            try:
                tokens = h.result(timeout=120.0)
            except Exception:  # noqa: BLE001 - a failed stream is counted below
                with lock:
                    results.append((a, None, None, None))
                return
            total_s = time.monotonic() - t_sub
            tr = h.trace_dict()
            with lock:
                results.append((a, tokens, tr.get("ttft_s"), total_s))

        t0 = time.monotonic()
        for a in schedule:
            delay = a.t - (time.monotonic() - t0)
            if delay > 0:
                time.sleep(delay)
            t_sub = time.monotonic()
            h = gen.submit(
                a.prompt, SamplingParams(max_new_tokens=a.max_new),
                priority=a.priority,
            )
            th = threading.Thread(target=waiter, args=(a, h, t_sub), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=120)
        captures = {}
        for w, r in zip(warm, reps):
            for k, v in r.engine.trace_counts.items():
                d = v - w.get(k, 0)
                if d > 0:
                    captures[k] = captures.get(k, 0) + d
        gen.stop()
        return results, captures

    def metrics(results):
        comp = [x for x in results if x[1] is not None]
        ttfts = [t for (_, _, t, _) in comp if t is not None]
        tpots = [
            (tot - ttft) / max(1, len(toks) - 1)
            for (_, toks, ttft, tot) in comp
            if ttft is not None and len(toks) > 1
        ]
        return {
            "completed": len(comp),
            "ttft_p95_s": pct(ttfts, 0.95),
            "tpot_p50_s": pct(tpots, 0.50),
        }

    def build(name):
        # equal engine budget per arm: n prefill + n decode specialized
        # replicas vs 2n unified ones
        if name == "unified":
            return Fleet(
                make_engine, n=2 * args.ab_replicas, name=args.model,
                scheduler_kwargs=sk,
            )
        return DisaggregatedFleet(
            make_engine, n_prefill=args.ab_replicas,
            n_decode=args.ab_replicas, name=args.model,
            scheduler_kwargs=sk,
        )

    per_rep = {"unified": [], "disagg": []}
    streams: Dict[str, List] = {}
    capture_totals = {"unified": 0, "disagg": 0}
    problems: List[str] = []
    for rep in range(args.ab_repeats):
        for name in ("unified", "disagg"):  # interleaved: shared noise
            results, captures = run_arm(build(name))
            m = metrics(results)
            per_rep[name].append(m)
            capture_totals[name] += sum(captures.values())
            if captures:
                problems.append(f"{name} rep {rep}: steady-state captures {captures}")
            if m["completed"] != len(schedule):
                problems.append(
                    f"{name} rep {rep}: {m['completed']}/{len(schedule)} completed"
                )
            if rep == 0:
                streams[name] = sorted(
                    (tuple(a.prompt), tuple(toks))
                    for (a, toks, _, _) in results if toks is not None
                )

    exact = streams.get("unified") == streams.get("disagg")
    if not exact:
        problems.append("streams diverged between the unified and disagg arms")

    def best(name, key):
        vals = [m[key] for m in per_rep[name] if m[key] is not None]
        return min(vals) if vals else None

    summary = {
        name: {
            "ttft_p95_s": best(name, "ttft_p95_s"),
            "tpot_p50_s": best(name, "tpot_p50_s"),
            "per_rep": per_rep[name],
        }
        for name in ("unified", "disagg")
    }

    def ratio(key):
        u, d = summary["unified"][key], summary["disagg"][key]
        if u is None or d is None:
            problems.append(f"no {key} in an arm (nothing completed)")
            return 0.0
        return u / max(1e-9, d)

    ttft_ratio = ratio("ttft_p95_s")
    tpot_ratio = ratio("tpot_p50_s")
    if ttft_ratio < args.min_ttft_improvement:
        problems.append(
            f"TTFT p95 ratio {ttft_ratio:.3f} below floor {args.min_ttft_improvement}"
        )
    if tpot_ratio < args.min_tpot_improvement:
        problems.append(
            f"decode TPOT ratio {tpot_ratio:.3f} below floor {args.min_tpot_improvement}"
        )
    report = {
        "mode": "disagg_ab",
        "schedule": {
            "arrivals": len(schedule), "rate_rps": args.rate,
            "duration_s": args.duration, "seed": args.seed,
            "max_new": args.max_new,
        },
        "unified": summary["unified"],
        "disagg": summary["disagg"],
        "ttft_p95_ratio": ttft_ratio,
        "tpot_p50_ratio": tpot_ratio,
        "exact": exact,
        "steady_state_captures": capture_totals,
        "problems": problems,
        "ok": not problems,
    }
    _append_ab_history(args.history_out, report, args.device)
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--rate", type=float, default=50.0,
                    help="offered load, requests/s (Poisson)")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="schedule length, seconds")
    ap.add_argument("--mix", default="0.2,0.3,0.5",
                    help="interactive,standard,best_effort fractions")
    ap.add_argument("--deadlines", default="none,5,30",
                    help="deadline choices in seconds ('none' = no deadline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedule", default="",
                    help="replay a recorded arrival schedule (JSON) instead "
                    "of building one (in-process and --url modes)")
    ap.add_argument("--record-schedule", default="",
                    help="write the built arrival schedule here (JSON)")
    ap.add_argument("--record-only", action="store_true",
                    help="with --record-schedule: write the schedule and "
                    "exit without driving it")
    ap.add_argument("--max-new", type=int, default=None,
                    help="tokens per request (default 8; 32 in --disagg-ab)")
    ap.add_argument("--vocab", type=int, default=40)
    ap.add_argument("--slots", type=int, default=None,
                    help="in-process engine batch slots (default 4; 32 in "
                    "--disagg-ab)")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="in-process scheduler queue bound")
    ap.add_argument("--dt", type=float, default=0.01,
                    help="in-process virtual-clock tick")
    ap.add_argument("--device", default=None,
                    help="in-process engines' device (default: the GPU; "
                    "'cpu' for the CPU)")
    ap.add_argument("--url", default="",
                    help="drive a live server instead of in-process")
    ap.add_argument("--model", default="lm", help="model name (--url mode)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="--url mode: seconds each request may take")
    ap.add_argument("--out", default="", help="write the JSON report here")
    ap.add_argument("--disagg-ab", action="store_true",
                    help="unified vs disaggregated fleet A/B")
    ap.add_argument("--ab-repeats", type=int, default=3,
                    help="interleaved repeats per arm (best-of)")
    ap.add_argument("--ab-replicas", type=int, default=1,
                    help="disagg-ab pool width: n prefill + n decode vs "
                    "2n unified replicas")
    ap.add_argument("--min-ttft-improvement", type=float, default=1.0,
                    help="disagg-ab gate: unified/disagg TTFT p95 ratio floor")
    ap.add_argument("--min-tpot-improvement", type=float, default=1.0,
                    help="disagg-ab gate: unified/disagg decode TPOT ratio floor")
    ap.add_argument("--history-out", default=None,
                    help="disagg-ab: append a perfwatch line here ('' disables; "
                    "default torch_tools_out/BENCH_HISTORY.jsonl)")
    args = ap.parse_args(argv)
    if args.max_new is None:
        args.max_new = 32 if args.disagg_ab else 8
    if args.slots is None:
        args.slots = 32 if args.disagg_ab else 4
    if args.history_out is None:
        args.history_out = out_path("BENCH_HISTORY.jsonl") if args.disagg_ab else ""
    args.mix_t = tuple(float(x) for x in args.mix.split(","))
    args.deadlines_t = tuple(
        None if x.strip().lower() == "none" else float(x)
        for x in args.deadlines.split(",")
    )
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.record_only:
        if not args.record_schedule:
            print("--record-only needs --record-schedule FILE", file=sys.stderr)
            return 2
        resolve_schedule(args)
        return 0
    if args.disagg_ab:
        report = run_disagg_ab(args)
    elif args.url:
        report = run_http(args)
    else:
        report = run_inprocess(args)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.disagg_ab and not report["ok"]:
        for p in report["problems"]:
            print(f"FAIL: {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
