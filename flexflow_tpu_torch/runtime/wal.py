"""Segment-based write-ahead log for durable serving (the port's copy of
``flexflow_tpu/runtime/wal.py``, standard library only: the same bytes on
disk, so a log written by either package is read by the other).

Every in-flight generation stream's replay state, its admission record
and its emitted-token deltas, is appended here so byte-exact
recompute-replay from prompt + seed survives *process death*, not just
an engine reset. The log is deliberately dumb: length-prefixed
CRC-framed JSON records in rotating segment files. All replay logic
lives in ``serving/durable.py``; this module only guarantees that what
was appended before the last group commit is readable after a SIGKILL,
and that a crash mid-append is *expected* (the torn tail of a segment
truncates on scan) rather than corruption.

Framing: ``<u32 length><u32 crc32(payload)><payload: UTF-8 JSON>``,
little-endian. A record that fails its length or CRC check at the END
of a segment (the file stops mid-header, mid-payload, or with one
trailing bad frame) is a torn tail: truncated and counted on scan. The
same failure with framed data AFTER it is real corruption and raises
:class:`WalCorruptionError` (fsync said that data was durable).

Group commit: :meth:`WriteAheadLog.append` only buffers;
:meth:`WriteAheadLog.flush` writes the buffer (one buffered write per
scheduler step) and hands the fsync to a background committer thread,
so the scheduler loop never waits on storage. The per-step write puts
the step's records in the page cache, which survives process death;
the committer paces its fsyncs to one per ``commit_interval_s``, which
bounds the host-death window to one interval. Both windows are safe:
tokens are a deterministic function of (prompt, seed, token count), so
replay regrows what a crash inside the window drops.
:meth:`WriteAheadLog.sync` fsyncs inline on the calling thread (the
warm-restart re-journal and teardown).

Reaping: a non-active segment is deleted once every stream whose latest
ADMIT record lives in it has ENDed. Orphan TOK/END records of reaped
streams are skipped on replay.

Fault sites: ``serving.wal_append`` (an injected error degrades the ONE
appending stream to non-durable; the caller owns that policy) and
``serving.wal_fsync`` (around every fsync; an injected error is absorbed
and counted, and the next commit cycle retries).
"""
from __future__ import annotations

import io
import json
import os
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple

from . import faults

WAL_VERSION = 1
_FRAME = struct.Struct("<II")  # (payload length, crc32(payload))
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".seg"


class WalError(RuntimeError):
    """Base class for WAL failures."""


class WalCorruptionError(WalError):
    """A record failed its CRC/length check somewhere fsync had already
    promised durability (mid-segment, or any older segment) — NOT the
    expected torn tail of the newest segment."""


def _segment_name(index: int, prefix: str = _SEG_PREFIX) -> str:
    return f"{prefix}{index:08d}{_SEG_SUFFIX}"


def _segment_index(name: str, prefix: str = _SEG_PREFIX) -> Optional[int]:
    if not (name.startswith(prefix) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(prefix):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def list_segments(
    dirpath: str, prefix: str = _SEG_PREFIX
) -> List[Tuple[int, str]]:
    """(index, absolute path) for every segment file, index-ascending.

    ``prefix`` selects the segment family sharing this directory tree:
    the default ``wal-`` journal, or sidecar rings framed the same way
    (the journey span spool uses ``journey-``)."""
    out = []
    try:
        names = os.listdir(dirpath)
    except FileNotFoundError:
        return []
    for name in names:
        idx = _segment_index(name, prefix)
        if idx is not None:
            out.append((idx, os.path.join(dirpath, name)))
    return sorted(out)


def encode_record(record: Dict) -> bytes:
    payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def read_segment(
    path: str, *, truncate_torn: bool = False
) -> Tuple[List[Dict], int]:
    """Decode one segment file. Returns ``(records, torn)`` where
    ``torn`` counts bad tails dropped.

    Torn vs corrupt: a file that simply ENDS early — mid-header,
    mid-payload, or with its very last frame failing CRC/decode — is a
    torn tail, the expected shape of a crash mid-append (with
    ``truncate_torn`` it is cut off the file in place; without, it
    raises). A bad record with MORE framed data after it is real
    corruption — fsync promised that byte range, and truncating it
    would silently drop records that WERE durable — and always raises
    :class:`WalCorruptionError`."""
    records: List[Dict] = []
    with open(path, "rb") as f:
        data = f.read()
    offset = 0
    bad_at: Optional[int] = None
    mid_file = False
    while offset < len(data):
        header = data[offset:offset + _FRAME.size]
        if len(header) < _FRAME.size:
            bad_at = offset  # cut mid-header: torn
            break
        length, crc = _FRAME.unpack(header)
        payload = data[offset + _FRAME.size:offset + _FRAME.size + length]
        if len(payload) < length:
            bad_at = offset  # cut mid-payload: torn
            break
        ok = zlib.crc32(payload) == crc
        rec = None
        if ok:
            try:
                rec = json.loads(payload.decode("utf-8"))
            except ValueError:
                ok = False
        if not ok:
            bad_at = offset
            # full frame present but bad: torn only if nothing follows
            mid_file = offset + _FRAME.size + length < len(data)
            break
        records.append(rec)
        offset += _FRAME.size + length
    if bad_at is None:
        return records, 0
    if mid_file:
        raise WalCorruptionError(
            f"{path}: record at byte {bad_at} failed its CRC/decode check "
            f"with framed data after it — mid-file corruption, not a torn "
            f"tail"
        )
    if not truncate_torn:
        raise WalCorruptionError(
            f"{path}: torn tail at byte {bad_at} in a segment not eligible "
            f"for truncation"
        )
    with open(path, "r+b") as f:
        f.truncate(bad_at)
    return records, 1


class WriteAheadLog:
    """Appender over a directory of rotating segment files.

    One writer per directory — ownership is cooperative (the durable
    tier closes the predecessor's log before a successor opens the
    directory). Opening never destroys existing segments: the active
    segment starts at ``max(existing) + 1`` so a warm restart can scan
    everything the dead process left behind while this process appends.
    """

    def __init__(
        self,
        dirpath: str,
        *,
        max_segment_bytes: int = 1 << 20,
        fsync: bool = True,
        commit_interval_s: float = 0.05,
        fingerprint: str = "",
        wall_clock: Callable[[], float] = time.time,
    ):
        os.makedirs(dirpath, exist_ok=True)
        self.dirpath = dirpath
        self.max_segment_bytes = max_segment_bytes
        self.fsync_enabled = fsync
        self.commit_interval_s = commit_interval_s
        self.fingerprint = fingerprint
        self.wall_clock = wall_clock
        self._lock = threading.Lock()
        existing = list_segments(dirpath)
        self._seg_index = (existing[-1][0] + 1) if existing else 0  # guarded-by: _lock
        self._file: Optional[io.BufferedWriter] = None  # guarded-by: _lock
        self._seg_bytes = 0  # guarded-by: _lock
        self._buffer: List[bytes] = []  # pending group-commit frames; guarded-by: _lock
        # reaping state: stream id -> segment of its latest ADMIT, and
        # per-segment set of still-open stream ids admitted there
        self._admit_segment: Dict[str, int] = {}  # guarded-by: _lock
        self._open_by_segment: Dict[int, Set[str]] = {}  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        # predecessor segments (index < the starting active index) are
        # protected from reaping until a warm restart declares them
        # recovered — without this, a process that attached durability
        # but skipped replay would delete a dead sibling's journal on
        # its first flush (no open-stream bookkeeping covers them)
        self._reap_floor = self._seg_index  # guarded-by: _lock
        # reap only when something could have become reapable: an END
        # landed or a rotation sealed a segment — NOT on every flush
        # (a directory scan per scheduler step is pure hot-path waste)
        self._reap_dirty = False  # guarded-by: _lock
        # telemetry (read via locked snapshot methods)
        self._appends = 0  # guarded-by: _lock
        self._bytes = 0  # guarded-by: _lock
        self._fsyncs = 0  # guarded-by: _lock
        self._fsync_seconds: List[float] = []  # last 256 fsync wall costs; guarded-by: _lock
        self._reaped = 0  # guarded-by: _lock
        self._fsync_failures = 0  # guarded-by: _lock
        # commit frontier: flush() bumps _commit_requested after its
        # write; the committer thread fsyncs and advances _commit_done.
        # Requests issued while a commit is in flight coalesce into the
        # next cycle — the disk falling behind widens the group, it
        # never queues per-step work.
        self._commit_cv = threading.Condition()
        self._commit_requested = 0  # guarded-by: _commit_cv
        self._commit_done = 0  # guarded-by: _commit_cv
        self._commit_stop = False  # guarded-by: _commit_cv
        # claim the active segment EAGERLY (header written now): a
        # sibling writer on the same directory (a process being replaced
        # beside its replacement) sees the claimed index in its rotate
        # rescan and never collides with it
        with self._lock:
            self._ensure_segment_locked()
        self._committer = threading.Thread(
            target=self._commit_loop, name=f"wal-commit:{dirpath}",
            daemon=True,
        )
        self._committer.start()

    # ---------------------------------------------------------- appending
    def append(self, record: Dict) -> None:
        """Frame + buffer one record (durable only after :meth:`flush`).
        The ``serving.wal_append`` fault site fires first; an injected
        error propagates to the caller, which degrades that one stream
        to non-durable — the decode hot path never blocks here."""
        faults.inject(faults.SERVING_WAL_APPEND, record.get("t"))
        frame = encode_record(record)
        with self._lock:
            if self._closed:
                raise WalError("write-ahead log is closed")
            self._buffer.append(frame)
            self._appends += 1
            self._bytes += len(frame)
            self._note_stream_locked(record)

    def _note_stream_locked(self, record: Dict) -> None:
        kind = record.get("t")
        sid = record.get("id")
        if sid is None:
            return
        if kind == "admit":
            prev = self._admit_segment.get(sid)
            if prev is not None:
                self._open_by_segment.get(prev, set()).discard(sid)
            # the admit lands in the segment the NEXT flush writes to
            self._admit_segment[sid] = self._seg_index
            self._open_by_segment.setdefault(self._seg_index, set()).add(sid)
        elif kind == "end":
            seg = self._admit_segment.pop(sid, None)
            if seg is not None:
                self._open_by_segment.get(seg, set()).discard(sid)
            self._reap_dirty = True  # a sealed segment may be done now

    def flush(self) -> None:
        """Group commit, write half: push every record buffered since
        the last flush through ONE buffered write, rotate/reap if
        anything became eligible, and request an asynchronous fsync
        from the committer thread. Called once per scheduler step; the
        step loop pays microseconds of syscall, never disk latency. A
        write failure (full disk) is absorbed like a failed fsync —
        counted, and generation continues with durability degraded."""
        with self._lock:
            if not self._buffer or self._closed:
                return
            frames, self._buffer = self._buffer, []
            try:
                f = self._ensure_segment_locked()
                for frame in frames:
                    f.write(frame)
                    self._seg_bytes += len(frame)
                f.flush()
            except OSError:
                self._fsync_failures += 1
                return
            if self._seg_bytes >= self.max_segment_bytes:
                self._rotate_locked()
                self._reap_dirty = True
            if self._reap_dirty:
                self._reap_locked()
                self._reap_dirty = False
        with self._commit_cv:
            self._commit_requested += 1
            self._commit_cv.notify_all()

    def sync(self) -> None:
        """Hard durability point: flush the buffer, then fsync INLINE
        on the calling thread and advance the commit frontier past
        everything written — no waiting out the committer's pacing
        interval. The warm-restart re-journal, a rolling restart's
        watermark checkpoint, and teardown call this; the per-step
        path never does. Failures degrade like the committer's: the
        frontier still advances (the caller is not retry-looped
        against a dead disk) with the miss counted."""
        self.flush()
        with self._commit_cv:
            target = self._commit_requested
            if self._commit_done >= target:
                return
        self._commit_once(target)

    def _commit_once(self, target: int) -> None:
        """One fsync cycle advancing the commit frontier to ``target``
        (shared by the committer thread and inline :meth:`sync`). The
        ``serving.wal_fsync`` fault site fires here; an injected error
        (or a real disk hiccup) is absorbed and counted — the NEXT
        cycle retries, and durability degrades by one commit interval
        rather than surfacing to any caller. Two concurrent cycles are
        safe: fsync serializes in the kernel and the frontier only
        moves forward."""
        with self._lock:
            f = self._file
        t0 = time.perf_counter()
        failed = False
        try:
            faults.inject(faults.SERVING_WAL_FSYNC, target)
            if self.fsync_enabled and f is not None:
                os.fsync(f.fileno())
        except (faults.FaultInjected, faults.TransientDeviceError,
                OSError, ValueError):
            # ValueError: the file rotated closed under us — its
            # bytes were fsynced by the rotation itself, but count
            # the miss rather than claim a sync we did not perform
            failed = True
        with self._lock:
            if failed:
                self._fsync_failures += 1
            else:
                self._fsyncs += 1
                self._fsync_seconds.append(time.perf_counter() - t0)
                del self._fsync_seconds[:-256]
        with self._commit_cv:
            if self._commit_done < target:
                self._commit_done = target
            self._commit_cv.notify_all()

    def _commit_loop(self) -> None:
        """Committer thread: whenever the commit frontier is behind,
        sleep out the pacing interval (so every step that lands in the
        meantime coalesces into ONE fsync — on small hosts the fsync
        and the wakeup both steal cycles from the compute threads, so
        the cadence, not just the placement, is the cost), then commit
        everything written so far. Stop requests skip the pacing sleep
        so teardown stays prompt."""
        while True:
            with self._commit_cv:
                while (not self._commit_stop
                       and self._commit_requested == self._commit_done):
                    self._commit_cv.wait()
                if (self._commit_stop
                        and self._commit_requested == self._commit_done):
                    return
                stopping = self._commit_stop
            if not stopping and self.commit_interval_s > 0:
                time.sleep(self.commit_interval_s)
            with self._commit_cv:
                target = self._commit_requested
            self._commit_once(target)

    def _ensure_segment_locked(self) -> io.BufferedWriter:
        if self._file is None:
            path = os.path.join(self.dirpath, _segment_name(self._seg_index))
            created = not os.path.exists(path)
            self._file = open(path, "ab")
            self._seg_bytes = self._file.tell()
            if self._seg_bytes == 0:
                header = encode_record({
                    "t": "header", "v": WAL_VERSION, "seg": self._seg_index,
                    "fp": self.fingerprint, "wall": self.wall_clock(),
                })
                self._file.write(header)
                self._seg_bytes += len(header)
            if created and self.fsync_enabled:
                # a new segment's NAME must survive the crash too: fsync
                # the directory entry once per segment (best-effort —
                # some filesystems refuse O_RDONLY directory fsync)
                try:
                    dfd = os.open(self.dirpath, os.O_RDONLY)
                    try:
                        os.fsync(dfd)
                    finally:
                        os.close(dfd)
                except OSError:
                    pass
        return self._file

    def _rotate_locked(self) -> None:
        if self._file is not None:
            # seal the outgoing segment synchronously: the committer
            # only ever fsyncs the ACTIVE file, so the rotation itself
            # must be the sealed segment's last durability point.
            # Rotation is per-megabyte, not per-step — this fsync is
            # off the hot path by construction.
            try:
                self._file.flush()
                if self.fsync_enabled:
                    os.fsync(self._file.fileno())
                    self._fsyncs += 1
            except OSError:
                self._fsync_failures += 1
            self._file.close()
            self._file = None
        # rescan for the next free index rather than blindly +1: a
        # sibling writer (a process and its replacement on one
        # directory) may have claimed indices past ours
        existing = list_segments(self.dirpath)
        floor = (existing[-1][0] + 1) if existing else 0
        self._seg_index = max(self._seg_index + 1, floor)
        self._seg_bytes = 0
        self._ensure_segment_locked()

    def _reap_locked(self) -> None:
        for idx, path in list_segments(self.dirpath):
            if idx >= self._seg_index:
                continue  # the active (or future) segment never reaps
            if idx < self._reap_floor:
                continue  # predecessor journal awaiting warm restart
            if self._open_by_segment.get(idx):
                continue  # a resident stream's admit still lives here
            try:
                os.remove(path)
                self._reaped += 1
            except OSError:
                pass  # a missed reap retries on the next flush
            self._open_by_segment.pop(idx, None)

    def mark_recovered(self) -> None:
        """Warm restart completed: every unfinished stream found in the
        predecessor segments has been re-journaled into THIS log's
        active segment (and flushed), so the old segments are dead
        weight — release them to the normal reaping sweep. Crash-safe
        ordering: call only AFTER the re-journal flush, so a crash in
        between replays the old records again (idempotent — the newer
        re-ADMIT wins by journal order)."""
        with self._lock:
            self._reap_floor = 0
            self._reap_locked()

    def close(self) -> None:
        """Drain the committer, write + fsync any buffered tail, and
        release the file handle. Idempotent; a closed log rejects
        further appends. Never raises out of a teardown path."""
        with self._commit_cv:
            already = self._commit_stop
            self._commit_stop = True
            self._commit_cv.notify_all()
        if not already and self._committer.is_alive():
            # the committer finishes any in-flight cycle, then exits;
            # bounded join so a wedged disk cannot hang teardown
            self._committer.join(timeout=5.0)
        with self._lock:
            if self._closed:
                return
            frames, self._buffer = self._buffer, []
            try:
                if frames:
                    f = self._ensure_segment_locked()
                    for frame in frames:
                        f.write(frame)
                    f.flush()
                if self._file is not None:
                    if self.fsync_enabled:
                        os.fsync(self._file.fileno())
                        self._fsyncs += 1
                    self._file.close()
            except OSError:
                pass  # closing must never raise out of a teardown path
            self._file = None
            self._closed = True

    # ---------------------------------------------------------- telemetry
    def watermark(self) -> Dict:
        """Locked snapshot of the commit frontier: what is durable now
        (a rolling restart's checkpoint). ``commit_lag`` is the
        number of flush cycles written but not yet fsynced — 0 right
        after :meth:`sync`."""
        with self._commit_cv:
            lag = self._commit_requested - self._commit_done
        with self._lock:
            return {
                "segment": self._seg_index,
                "segment_bytes": self._seg_bytes,
                "appends": self._appends,
                "unflushed": len(self._buffer),
                "commit_lag": lag,
                "open_streams": len(self._admit_segment),
            }

    def counters(self) -> Dict:
        with self._lock:
            fs = sorted(self._fsync_seconds)
            return {
                "appends": self._appends,
                "bytes": self._bytes,
                "fsyncs": self._fsyncs,
                "fsync_failures": self._fsync_failures,
                "reaped_segments": self._reaped,
                "fsync_p50_s": fs[len(fs) // 2] if fs else 0.0,
            }

    def segment_count(self) -> int:
        """Segments currently on disk (the wal_segments gauge)."""
        return len(list_segments(self.dirpath))

    @property
    def active_index(self) -> int:
        """The segment this log is currently appending to; a warm
        restart scans strictly below it."""
        with self._lock:
            return self._seg_index


def scan_wal(
    dirpath: str, *, before_index: Optional[int] = None
) -> Tuple[List[Dict], int]:
    """Read every record in segment order, truncating torn tails in
    place. Returns ``(records, torn_records)``.

    ``before_index`` excludes this process's OWN active segment (and
    anything after it) from a warm-restart scan — pass
    ``WriteAheadLog.active_index``. Torn-tail truncation applies to
    every scanned segment: each dead writer generation may leave one
    (crash mid-append), and :func:`read_segment` still raises
    :class:`WalCorruptionError` for mid-file damage — data fsync
    promised is never silently dropped."""
    segments = list_segments(dirpath)
    if before_index is not None:
        segments = [(i, p) for (i, p) in segments if i < before_index]
    records: List[Dict] = []
    torn = 0
    for _idx, path in segments:
        recs, cut = read_segment(path, truncate_torn=True)
        records.extend(recs)
        torn += cut
    return records, torn


class StreamReplay:
    """Replay state for one journaled stream, folded from its records."""

    __slots__ = ("admit", "tokens", "ended", "outcome", "order")

    def __init__(self, admit: Dict, order: int):
        self.admit = admit
        self.tokens: List[int] = list(admit.get("generated", ()))
        self.ended = False
        self.outcome: Optional[str] = None
        self.order = order


def replay_streams(records: List[Dict]) -> List[StreamReplay]:
    """Fold a record scan into per-stream replay state, in journal
    (admission) order. A re-ADMIT of the same id (preemption, migration
    back) resets that stream's state to the newer snapshot; TOK deltas
    extend it; END closes it. Orphan TOK/END records whose admit lived
    in an already-reaped segment are skipped."""
    streams: Dict[str, StreamReplay] = {}
    order = 0
    for rec in records:
        kind = rec.get("t")
        sid = rec.get("id")
        if kind == "admit":
            streams[sid] = StreamReplay(rec, order)
            order += 1
        elif kind == "tok":
            s = streams.get(sid)
            if s is not None and not s.ended:
                s.tokens.extend(int(t) for t in rec.get("toks", ()))
        elif kind == "end":
            s = streams.get(sid)
            if s is not None:
                s.ended = True
                s.outcome = rec.get("outcome")
    return sorted(streams.values(), key=lambda s: s.order)


def wal_fingerprints(records: List[Dict]) -> List[str]:
    """Distinct non-empty fingerprints across every segment header, in
    first-seen order — the warm-restart compatibility check input."""
    seen: List[str] = []
    for rec in records:
        if rec.get("t") == "header":
            fp = rec.get("fp") or ""
            if fp and fp not in seen:
                seen.append(fp)
    return seen
