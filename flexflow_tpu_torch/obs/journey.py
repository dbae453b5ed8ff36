"""Request journeys: distributed tracing of one request across every
process that touched it, surviving process death and warm restart (the
port's copy of ``flexflow_tpu/obs/journey.py``, standard library only).

A *journey* is one request's end-to-end causal timeline. The
per-scheduler observability (:class:`~flexflow_tpu_torch.obs.trace.RequestTrace`,
the trace and flight rings) answers "why was this request slow here";
the journey follows the request across the HTTP ingress, the scheduler,
and a WAL warm restart in another process. The model is Dapper's
(Sigelman et al., 2010):

* a stable 32-hex **journey id** is minted at ingress or at first
  submit, and accepted/emitted as a W3C ``traceparent`` header so
  external tracers join the same tree;
* every **hop** (ingress -> route -> submit -> admit -> prefill -> KV
  handoff -> decode-pool adopt -> failover re-admission -> journal
  replay -> warm restart -> SSE resume -> finish) records one
  :class:`JourneySpan` whose parent is the previous hop's span id. The
  chain is sequential on purpose: "gap-free parent links" is then a
  checkable property (every non-root span's parent exists);
* spans land in the owning lane's :class:`JourneyRecorder` (a bounded
  ring) and, when durability is on, are mirrored into a
  :class:`JourneySpool`, a bounded on-disk ring of CRC-framed segments
  next to the WAL, so pre-crash hops stay joinable after SIGKILL;
* a :class:`JourneyIndex` stitches spans from any number of recorders
  and spools into one timeline at query time (``GET
  /v2/debug/journey/{id}``), rendered as chrome://tracing JSON (one lane
  per recorder) and an OTLP-compatible JSON shape.

The :class:`JourneyContext` travels ON the Request object, like its
RequestTrace: adoption retargets ``ctx.recorder`` at the adopting
scheduler, and the WAL admission snapshot carries ``(journey_id,
last_span_id, hops)`` so a warm-restarted stream keeps its identity and
its next spans parent onto the pre-crash chain. ``ctx.hops`` counts
every hop *attempted*, independent of what the rings retained, so a
completeness check can compare it with the stitched span count.

A fleet's journey crosses lanes: the router's (``{rid_prefix}router``),
then each replica's (its id), so one journey stitches across a failover
or a prefill -> decode handoff.

Thread-safety: contexts are touched by transport threads, the scheduler
loops, the watchdog and the handoff worker; a per-context lock keeps the (parent chain, hop
count) pair consistent, and recorders and spools guard their rings with
their own locks. ``NULL_JOURNEY`` is the journeys-off stand-in: every
method is a no-op, so the disabled path stays branch-free and
byte-exact.

Timestamps come from each recorder's injectable clock (the scheduler's,
possibly virtual); stitching orders by parent chain first and t0 second,
so mixed clocks cannot scramble causality. The renderings name the
service ``flexflow_tpu`` as the JAX package does, so a trace collector
sees one service whichever package served the request.
"""
from __future__ import annotations

import json
import os
import re
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


def new_journey_id() -> str:
    """32-hex W3C trace id (never all zeroes)."""
    jid = os.urandom(16).hex()
    return jid if jid != "0" * 32 else new_journey_id()


def new_span_id() -> str:
    """16-hex W3C span id (never all zeroes)."""
    sid = os.urandom(8).hex()
    return sid if sid != "0" * 16 else new_span_id()


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a W3C traceparent header, or
    None for anything malformed (a bad header must never fail a
    request — the journey just roots locally)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(journey_id: str, span_id: str) -> str:
    return f"00-{journey_id}-{span_id}-01"


class JourneySpan:
    """One hop of one journey. Immutable once recorded."""

    __slots__ = (
        "journey_id", "span_id", "parent_id", "name", "lane",
        "t0", "t1", "attrs",
    )

    def __init__(self, journey_id: str, span_id: str,
                 parent_id: Optional[str], name: str, lane: str,
                 t0: float, t1: float, attrs: Optional[Dict] = None):
        self.journey_id = journey_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.lane = lane
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    def to_dict(self) -> Dict:
        return {
            "journey_id": self.journey_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "lane": self.lane,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": self.attrs,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "JourneySpan":
        return cls(
            d["journey_id"], d["span_id"], d.get("parent_id"),
            d.get("name", "?"), d.get("lane", "?"),
            float(d.get("t0", 0.0)), float(d.get("t1", 0.0)),
            d.get("attrs") or {},
        )


class JourneyContext:
    """The journey state that travels ON a Request: identity (journey
    id), the tip of the parent chain, the attempted-hop count, and the
    CURRENT recorder (retargeted at adoption, exactly like the trace
    ring). ``remote_parent`` marks an id joined from an external
    ``traceparent`` — its root span legitimately has a parent outside
    this process, and completeness checks must not call that a gap."""

    __slots__ = ("journey_id", "last_span_id", "hops", "recorder",
                 "remote_parent", "_lock")

    def __init__(self, journey_id: str,
                 parent_span_id: Optional[str] = None,
                 recorder: Optional["JourneyRecorder"] = None,
                 remote_parent: bool = False,
                 hops: int = 0):
        self.journey_id = journey_id
        self.last_span_id = parent_span_id  # guarded-by: _lock
        self.hops = hops                    # guarded-by: _lock
        self.recorder = recorder
        self.remote_parent = remote_parent
        self._lock = threading.Lock()

    def hop(self, name: str, t0: Optional[float] = None, **attrs) -> Optional[str]:
        """Record one hop on the current recorder: allocate a span id,
        link it under the chain tip, advance the tip. Returns the new
        span id (None when journeys are off for this request). A hop is
        COUNTED the moment the chain advances — if the recorder then
        drops the span, the stitched journey comes up short against
        ``hops`` and the completeness gates fail loudly."""
        rec = self.recorder
        if rec is None:
            return None
        span_id = new_span_id()
        with self._lock:
            parent = self.last_span_id
            self.last_span_id = span_id
            self.hops += 1
        rec.record_span(self, span_id, parent, name, t0=t0, attrs=attrs)
        return span_id

    def traceparent(self) -> Optional[str]:
        with self._lock:
            tip = self.last_span_id
        return format_traceparent(self.journey_id, tip or "0" * 16) \
            if tip else format_traceparent(self.journey_id, new_span_id())

    def snapshot(self) -> Dict:
        """Durable identity for the WAL admission record."""
        with self._lock:
            return {
                "id": self.journey_id,
                "parent": self.last_span_id,
                "hops": self.hops,
                "remote": self.remote_parent,
            }

    @classmethod
    def restore(cls, snap: Dict) -> "JourneyContext":
        """Rebuild a context from a WAL admission snapshot: the
        warm-restarted stream keeps its journey id and its next hop
        parents onto the pre-crash chain tip."""
        return cls(
            snap["id"], parent_span_id=snap.get("parent"),
            remote_parent=bool(snap.get("remote")),
            hops=int(snap.get("hops", 0)),
        )


class _NullJourney:
    """Journeys-off stand-in (observability disabled, or the feature
    gated off): every call is a no-op so hot paths stay branch-free."""

    __slots__ = ()

    journey_id = None
    last_span_id = None
    hops = 0
    recorder = None
    remote_parent = False

    def hop(self, *a, **k):
        return None

    def traceparent(self):
        return None

    def snapshot(self):
        return None


NULL_JOURNEY = _NullJourney()


class JourneyStats:
    """Journey counters for one recorder, surfaced as /v2/stats gauges
    and the ``flexflow_serving_journey_*`` Prometheus families:

      journeys        contexts minted (roots + remote-parent joins)
      spans           hops recorded into the ring
      spooled_spans   spans mirrored into the on-disk spool
      spool_truncated torn spool tails truncated on scan (crash
                      mid-append — expected, counted, never silent)
      remote_parents  journeys joined from an external traceparent

    Writers: transport threads (mint) and scheduler threads (record);
    the lock keeps counts exact so a test can assert span completeness
    against them.
    """

    FIELDS = (
        "journeys", "spans", "spooled_spans", "spool_truncated",
        "remote_parents",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def incr(self, field: str, n: int = 1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown journey counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def register_gauges(self, stats) -> None:
        # cumulative counters -> prometheus-conventional _total names
        # (flexflow_serving_journey_* once prom.py prefixes them)
        for f in self.FIELDS:
            stats.add_gauge(f"journey_{f}_total", lambda f=f: getattr(self, f))


# spool framing mirrors runtime/wal.py exactly (length + crc32 + JSON);
# the segment prefix differs so a spool can live next to WAL segments
# in one directory tree without scan_wal ever confusing the two
_FRAME = struct.Struct("<II")
_SPOOL_PREFIX = "journey-"
_SPOOL_SUFFIX = ".seg"


class JourneySpool:
    """Bounded on-disk ring of finished spans, next to the WAL segments:
    the durability layer for journeys. Appends are CRC-framed JSON in
    rotating segments; the ring is bounded by ``max_bytes`` — oldest
    segments are deleted first, so the spool can never grow past its
    budget no matter how long the process lives. Like the WAL's
    process-death story, appends are flushed to the OS (page cache) but
    NOT fsynced: a SIGKILL loses nothing, and journeys are diagnostics —
    host death may cost the newest spans, never correctness.

    ``scan()`` truncates a torn tail (crash mid-append) off the newest
    segment in place and counts it, mirroring the WAL's open semantics.
    """

    def __init__(self, dirpath: str, *, max_bytes: int = 1 << 20,
                 segment_bytes: int = 64 << 10,
                 stats: Optional[JourneyStats] = None):
        self.dir = dirpath
        self.max_bytes = max(4096, int(max_bytes))
        self.segment_bytes = max(1024, int(segment_bytes))
        self.stats = stats
        self._lock = threading.Lock()
        os.makedirs(dirpath, exist_ok=True)
        segs = self._segments()
        self._index = (segs[-1][0] + 1) if segs else 0  # guarded-by: _lock
        self._fh = None                                  # guarded-by: _lock
        self._fh_bytes = 0                               # guarded-by: _lock

    # ------------------------------------------------------------ segments
    def _segments(self) -> List[Tuple[int, str]]:
        # same discovery as the WAL journal, selected by spool prefix —
        # both families can share one directory tree without collisions
        from ..runtime.wal import list_segments

        return list_segments(self.dir, prefix=_SPOOL_PREFIX)

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        path = os.path.join(
            self.dir, f"{_SPOOL_PREFIX}{self._index:08d}{_SPOOL_SUFFIX}"
        )
        self._index += 1
        self._fh = open(path, "ab")
        self._fh_bytes = self._fh.tell()
        # bound the ring: drop oldest whole segments past the budget
        segs = self._segments()
        total = 0
        sizes = []
        for idx, p in segs:
            try:
                sizes.append((idx, p, os.path.getsize(p)))
            except OSError:
                continue
        total = sum(s for _, _, s in sizes)
        for idx, p, s in sizes:
            if total <= self.max_bytes or p == self._fh.name:
                break
            try:
                os.remove(p)
                total -= s
            except OSError:
                break

    # ------------------------------------------------------------- appends
    def append(self, span: JourneySpan) -> None:
        payload = json.dumps(
            span.to_dict(), separators=(",", ":")
        ).encode("utf-8")
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._fh is None or self._fh_bytes >= self.segment_bytes:
                self._rotate_locked()
            try:
                self._fh.write(frame)
                self._fh.flush()  # page cache: survives SIGKILL
                self._fh_bytes += len(frame)
            except OSError:
                return  # diagnostics must never fail the hot path
        if self.stats is not None:
            self.stats.incr("spooled_spans")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # --------------------------------------------------------------- scans
    def scan(self) -> Tuple[List[JourneySpan], int]:
        """Every span on disk, oldest first, truncating (and counting) a
        torn tail on the NEWEST segment; a torn tail on an older segment
        is dropped but not truncated (that segment is sealed). Never
        raises: a corrupt spool degrades to fewer spans, not a failed
        debug endpoint."""
        spans: List[JourneySpan] = []
        torn = 0
        with self._lock:
            segs = self._segments()
            newest = segs[-1][1] if segs else None
        for _, path in segs:
            try:
                recs, t = _read_spool_segment(
                    path, truncate_torn=(path == newest)
                )
            except OSError:
                continue
            torn += t
            for rec in recs:
                try:
                    spans.append(JourneySpan.from_dict(rec))
                except (KeyError, TypeError, ValueError):
                    continue
        if torn and self.stats is not None:
            self.stats.incr("spool_truncated", torn)
        return spans, torn


def _read_spool_segment(path: str, *, truncate_torn: bool) -> Tuple[List[Dict], int]:
    """Spool segment reader: WAL framing, but lenient — ANY bad frame
    ends the scan of this segment (spool spans are diagnostics; the
    WAL's mid-file-corruption refusal would turn a damaged spool into a
    failed debug endpoint)."""
    records: List[Dict] = []
    with open(path, "rb") as f:
        data = f.read()
    offset = 0
    bad_at: Optional[int] = None
    while offset < len(data):
        header = data[offset:offset + _FRAME.size]
        if len(header) < _FRAME.size:
            bad_at = offset
            break
        length, crc = _FRAME.unpack(header)
        payload = data[offset + _FRAME.size:offset + _FRAME.size + length]
        if len(payload) < length:
            bad_at = offset
            break
        if zlib.crc32(payload) != crc:
            bad_at = offset
            break
        try:
            records.append(json.loads(payload.decode("utf-8")))
        except ValueError:
            bad_at = offset
            break
        offset += _FRAME.size + length
    if bad_at is None:
        return records, 0
    if truncate_torn:
        try:
            with open(path, "r+b") as f:
                f.truncate(bad_at)
        except OSError:
            pass
    return records, 1


class JourneyRecorder:
    """Per-process span sink for one lane (a scheduler, or
    an ingress surface): a bounded ring of finished spans plus an
    optional on-disk spool mirror. The ring answers live stitching; the
    spool survives the process."""

    def __init__(self, lane: str = "local",
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = 1024,
                 spool: Optional[JourneySpool] = None,
                 stats: Optional[JourneyStats] = None):
        self.lane = lane
        self.clock = clock
        self.stats = stats or JourneyStats()
        self.spool = spool
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, capacity))  # guarded-by: _lock

    # -------------------------------------------------------------- minting
    def mint(self, parent: Optional[Tuple[str, str]] = None) -> JourneyContext:
        """New context bound to this recorder. ``parent`` is a parsed
        remote ``traceparent`` — the journey joins that id and its first
        local span parents onto the remote span."""
        if parent is not None:
            ctx = JourneyContext(
                parent[0], parent_span_id=parent[1],
                recorder=self, remote_parent=True,
            )
            self.stats.incr("remote_parents")
        else:
            ctx = JourneyContext(new_journey_id(), recorder=self)
        self.stats.incr("journeys")
        return ctx

    # ------------------------------------------------------------ recording
    def record_span(self, ctx: JourneyContext, span_id: str,
                    parent_id: Optional[str], name: str,
                    t0: Optional[float] = None,
                    attrs: Optional[Dict] = None) -> None:
        now = self.clock()
        span = JourneySpan(
            ctx.journey_id, span_id, parent_id, name, self.lane,
            now if t0 is None else t0, now, attrs,
        )
        with self._lock:
            self._ring.append(span)
        self.stats.incr("spans")
        spool = self.spool
        if spool is not None:
            spool.append(span)

    # -------------------------------------------------------------- queries
    def spans(self, journey_id: Optional[str] = None) -> List[JourneySpan]:
        with self._lock:
            items = list(self._ring)
        if journey_id is None:
            return items
        return [s for s in items if s.journey_id == journey_id]

    def journey_ids(self) -> List[str]:
        """Distinct journey ids currently in the ring, newest first."""
        with self._lock:
            items = list(self._ring)
        seen, out = set(), []
        for s in reversed(items):
            if s.journey_id not in seen:
                seen.add(s.journey_id)
                out.append(s.journey_id)
        return out


class JourneyIndex:
    """Query-time stitcher over any set of recorders and spools: no
    registration state to keep consistent as schedulers come and go — the
    caller (the server's debug endpoint, a test) hands it
    the CURRENT recorders each time."""

    def __init__(self, recorders: Optional[List[JourneyRecorder]] = None,
                 spools: Optional[List[JourneySpool]] = None):
        self.recorders: List[JourneyRecorder] = list(recorders or [])
        self.spools: List[JourneySpool] = list(spools or [])

    def add(self, recorder: Optional[JourneyRecorder]) -> "JourneyIndex":
        if recorder is not None and recorder not in self.recorders:
            self.recorders.append(recorder)
        return self

    def add_spool(self, spool: Optional[JourneySpool]) -> "JourneyIndex":
        if spool is not None and spool not in self.spools:
            self.spools.append(spool)
        return self

    # ------------------------------------------------------------ stitching
    def _collect(self, journey_id: str) -> List[JourneySpan]:
        spans: Dict[str, JourneySpan] = {}
        for spool in self.spools:
            found, _ = spool.scan()
            for s in found:
                if s.journey_id == journey_id:
                    spans[s.span_id] = s
        for rec in self.recorders:
            for s in rec.spans(journey_id):
                # the live ring wins over the spool copy (same span)
                spans[s.span_id] = s
        return list(spans.values())

    def get(self, journey_id: str) -> Optional[Dict]:
        """The stitched journey: spans in causal (parent-chain) order,
        plus the connectivity verdict. None when no span of that id is
        known anywhere."""
        spans = self._collect(journey_id)
        if not spans:
            return None
        return stitch(journey_id, spans)

    def journey_ids(self) -> List[str]:
        seen, out = set(), []
        for rec in self.recorders:
            for jid in rec.journey_ids():
                if jid not in seen:
                    seen.add(jid)
                    out.append(jid)
        for spool in self.spools:
            found, _ = spool.scan()
            for s in found:
                if s.journey_id not in seen:
                    seen.add(s.journey_id)
                    out.append(s.journey_id)
        return out


def stitch(journey_id: str, spans: List[JourneySpan]) -> Dict:
    """Order ``spans`` by the parent chain (t0 breaks ties between
    stray branches) and report connectivity: ``complete`` means exactly
    one root and every other span's parent present — the "gap-free
    parent links" acceptance check, computed not asserted."""
    by_id = {s.span_id: s for s in spans}
    children: Dict[Optional[str], List[JourneySpan]] = {}
    roots: List[JourneySpan] = []
    orphans: List[JourneySpan] = []
    for s in spans:
        if s.parent_id is None or s.parent_id not in by_id:
            # a remote-parented root has a parent id that is simply not
            # ours; a true orphan mid-chain shows up the same way — the
            # single-root requirement tells them apart
            roots.append(s)
        children.setdefault(s.parent_id, []).append(s)
    ordered: List[JourneySpan] = []
    seen = set()

    def _walk(span: JourneySpan) -> None:
        stack = [span]
        while stack:
            cur = stack.pop()
            if cur.span_id in seen:
                continue
            seen.add(cur.span_id)
            ordered.append(cur)
            kids = sorted(
                children.get(cur.span_id, ()),
                key=lambda k: (k.t0, k.span_id), reverse=True,
            )
            stack.extend(kids)

    for root in sorted(roots, key=lambda s: (s.t0, s.span_id)):
        _walk(root)
    orphans = [s for s in spans if s.span_id not in seen]
    for s in sorted(orphans, key=lambda x: (x.t0, x.span_id)):
        _walk(s)
    complete = len(roots) == 1 and len(ordered) == len(spans)
    lanes = []
    for s in ordered:
        if s.lane not in lanes:
            lanes.append(s.lane)
    return {
        "journey_id": journey_id,
        "complete": complete,
        "n_spans": len(spans),
        "n_roots": len(roots),
        "lanes": lanes,
        "spans": [s.to_dict() for s in ordered],
    }


# ------------------------------------------------------------- renderings
def to_chrome_trace(journey: Dict) -> Dict:
    """chrome://tracing JSON: one lane (tid) per recorder, complete
    X events, plus flow arrows would be overkill — the parent chain is
    in each event's args."""
    events = []
    lanes = {lane: i for i, lane in enumerate(journey.get("lanes", []))}
    for s in journey["spans"]:
        events.append({
            "name": s["name"],
            "cat": "journey",
            "ph": "X",
            "ts": s["t0"] * 1e6,
            "dur": max(0.0, (s["t1"] - s["t0"])) * 1e6,
            "pid": f"journey:{journey['journey_id'][:8]}",
            "tid": lanes.get(s["lane"], len(lanes)),
            "args": {
                "lane": s["lane"],
                "span_id": s["span_id"],
                "parent_id": s["parent_id"],
                **(s.get("attrs") or {}),
            },
        })
    meta = [
        {
            "name": "thread_name", "ph": "M",
            "pid": f"journey:{journey['journey_id'][:8]}",
            "tid": idx, "args": {"name": lane},
        }
        for lane, idx in lanes.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def to_otlp(journey: Dict, service_name: str = "flexflow_tpu") -> Dict:
    """OTLP/JSON-compatible shape (one resource span set per lane).
    Timestamps are the recorders' clocks scaled to nanoseconds — on a
    virtual clock they are offsets, not epochs; OTLP consumers that
    require wall epochs should rebase on import."""
    by_lane: Dict[str, List[Dict]] = {}
    for s in journey["spans"]:
        by_lane.setdefault(s["lane"], []).append(s)
    resource_spans = []
    for lane, spans in by_lane.items():
        otlp_spans = []
        for s in spans:
            attrs = [
                {"key": str(k), "value": {"stringValue": str(v)}}
                for k, v in (s.get("attrs") or {}).items()
            ]
            otlp_spans.append({
                "traceId": s["journey_id"],
                "spanId": s["span_id"],
                "parentSpanId": s["parent_id"] or "",
                "name": s["name"],
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(int(s["t0"] * 1e9)),
                "endTimeUnixNano": str(int(s["t1"] * 1e9)),
                "attributes": attrs,
            })
        resource_spans.append({
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": service_name}},
                {"key": "flexflow.lane", "value": {"stringValue": lane}},
            ]},
            "scopeSpans": [{
                "scope": {"name": "flexflow_tpu.obs.journey"},
                "spans": otlp_spans,
            }],
        })
    return {"resourceSpans": resource_spans}
