"""Stage discovery: the repeated block structure of a graph (port of
``_node_signatures``, ``_blocks_equal``, ``detect_repeats``,
``boundary_values``, ``boundary_structure`` and ``balanced_stages`` from
``flexflow_tpu/parallel/pipeline.py``).

The executor's rematerialization (``FFConfig.remat_blocks``) wraps each
repeated block in ``torch.utils.checkpoint``; the strategy search costs
pipeline candidates over the same blocks (``search/unity.py``) and
``parallel/strategy.py::pipeline_strategy`` assigns their stages. The
GPipe schedule that runs such a strategy waits for the multi-GPU slices.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def _node_signatures(graph, order):
    """Cheap per-position prefilter signature: (op_type, params, in-edge
    (dst_idx, src_idx) shape). Edge wiring is checked exactly by
    _blocks_equal — the signature alone would either break on shared
    externals (a fixed encoder output read by every block sits at a
    different relative offset from each) or over-match."""
    sigs = []
    for n in order:
        edges = tuple(sorted((e.dst_idx, e.src_idx) for e in graph.in_edges(n)))
        sigs.append((n.op_type, n.params, edges))
    return sigs


def _blocks_equal(graph, order, pos, a1, a2, p):
    """Are order[a1:a1+p] and order[a2:a2+p] isomorphic blocks? Each
    in-edge pair must be INTERNAL with the same relative producer offset,
    or EXTERNAL in both blocks (producer before the block start) — the
    entry value of block 0 may sit far away in topo order (the tgt input
    behind a whole encoder) while later blocks read their predecessor.
    Which external wiring shapes are actually pipelinable is validated
    downstream by boundary_structure's rotating/shared contract."""
    for off in range(p):
        x, y = order[a1 + off], order[a2 + off]
        ex = sorted(graph.in_edges(x), key=lambda e: (e.dst_idx, e.src_idx))
        ey = sorted(graph.in_edges(y), key=lambda e: (e.dst_idx, e.src_idx))
        for e1, e2 in zip(ex, ey):
            int1 = pos[e1.src] >= a1
            int2 = pos[e2.src] >= a2
            if int1 != int2:
                return False
            if int1 and (a1 + off) - pos[e1.src] != (a2 + off) - pos[e2.src]:
                return False
    return True


def detect_repeats(graph):
    """Split the PCG into (pre, repeats, post) where ``repeats`` is the
    maximal run of structurally-isomorphic contiguous blocks (a
    transformer's encoder stack, or a decoder stack whose blocks all read
    one shared encoder output). Block isomorphism is what lets the
    executor stack per-block params [S, r, ...] and run them as ONE SPMD
    stage program under the GPipe schedule.

    Returns (pre: List[Node], repeats: List[List[Node]], post: List[Node]);
    repeats == [] when no periodic region of >= 2 blocks exists.
    """
    order = list(graph.topo_order())
    pos = {n.guid: i for i, n in enumerate(order)}
    sigs = _node_signatures(graph, order)
    n = len(order)
    # maximize covered nodes; tie-break earliest start, then SMALLEST
    # period (k repeats of one block beat k/2 repeats of a double block:
    # more repeats = more stage-count flexibility)
    best = None  # (coverage, -a, -p, a, p, k)
    for a in range(n - 1):
        if best is not None and best[0] >= n - a:
            break
        for p in range(1, (n - a) // 2 + 1):
            if sigs[a : a + p] != sigs[a + p : a + 2 * p]:
                continue  # prefilter
            if not _blocks_equal(graph, order, pos, a, a + p, p):
                continue
            k = 2
            while (
                a + (k + 1) * p <= n
                and sigs[a + k * p : a + (k + 1) * p] == sigs[a : a + p]
                and _blocks_equal(graph, order, pos, a, a + k * p, p)
            ):
                k += 1
            cand = (k * p, -a, -p, a, p, k)
            if best is None or cand > best:
                best = cand
    if best is None:
        return order, [], []
    _, _, _, a, p, k = best
    repeats = [order[a + j * p : a + (j + 1) * p] for j in range(k)]
    return order[:a], repeats, order[a + k * p :]


def boundary_values(graph, repeats):
    """Single-stream view of the boundary: ((in_guid, in_idx),
    (out_guid, out_idx)). Thin wrapper over boundary_structure — raises
    ValueError when the region needs the full tuple carry (several
    rotating streams or shared values), so single-stream callers keep
    their historical contract without a second validator to maintain."""
    rotating_in, shared, streams = boundary_structure(graph, repeats)
    if shared or len(rotating_in) != 1:
        raise ValueError(
            f"pipeline boundary carries {len(rotating_in)} rotating streams "
            f"+ {len(shared)} shared values (single-stream caller needs "
            "exactly 1 + 0); use boundary_structure for the tuple carry"
        )
    p, i = streams[0]
    return rotating_in[0], (repeats[-1][p].guid, i)


def boundary_structure(graph, repeats):
    """Classify the pipelined region's boundary for a TUPLE carry.

    Every external input slot of a repeat — identified structurally as
    (consumer's template position, dst_idx) — must be one of:
      * SHARED: every repeat reads the SAME (guid, idx) produced outside
        the region (a fixed encoder output feeding cross-attention);
      * ROTATING: repeat j reads what repeat j-1 produced at a fixed
        template-local position (the activation streams; one for
        residual stacks, several for two-stream boundaries).

    Returns (rotating_in, shared, out_streams):
      rotating_in: [(src_guid, src_idx)] values entering repeat 0 from
        the pre-region, one per distinct rotating stream, canonical order;
      shared: [(src_guid, src_idx)] produced outside the region;
      out_streams: [(template_pos, out_idx)] aligned with rotating_in —
        where each stream leaves a block, template-locally.
    Raises ValueError for boundary shapes outside this contract (e.g. a
    skip connection reaching across two blocks).
    """
    region_guids = {n.guid for rep in repeats for n in rep}
    # per-repeat guid sets and guid->position maps, hoisted once — the
    # slot/stream/escape checks below all index into them
    rep_guids = [{n.guid for n in rep} for rep in repeats]
    rep_pos = [{n.guid: i for i, n in enumerate(rep)} for rep in repeats]

    def slots(j):
        guids, pos, out = rep_guids[j], rep_pos[j], {}
        for node in repeats[j]:
            for e in graph.in_edges(node):
                if e.src not in guids:
                    out[(pos[node.guid], e.dst_idx)] = (e.src, e.src_idx)
        return out

    per_rep = [slots(j) for j in range(len(repeats))]
    slot_keys = sorted(per_rep[0])
    for j, s in enumerate(per_rep[1:], 1):
        if sorted(s) != slot_keys:
            raise ValueError(
                f"repeat {j} external-input slots {sorted(s)} differ from "
                f"template slots {slot_keys}"
            )

    shared: List[Tuple[int, int]] = []
    # stream key (template_pos, out_idx) -> entry value for repeat 0
    stream_entry: Dict[Tuple[int, int], Tuple[int, int]] = {}
    stream_order: List[Tuple[int, int]] = []
    for key in slot_keys:
        vals = [s[key] for s in per_rep]
        if all(v == vals[0] for v in vals) and vals[0][0] not in region_guids:
            if vals[0] not in shared:
                shared.append(vals[0])
            continue
        # rotating: repeat j's producer must sit in repeat j-1 at one
        # fixed template position
        stream = None
        for j in range(1, len(repeats)):
            src, idx = per_rep[j][key]
            prev_pos = rep_pos[j - 1]
            if src not in prev_pos:
                raise ValueError(
                    f"slot {key}: repeat {j} reads {(src, idx)} which is neither "
                    "shared nor produced by the previous repeat"
                )
            this = (prev_pos[src], idx)
            if stream is None:
                stream = this
            elif stream != this:
                raise ValueError(
                    f"slot {key}: producer position varies across repeats "
                    f"({stream} vs {this})"
                )
        entry = per_rep[0][key]
        if entry[0] in region_guids:
            raise ValueError(f"slot {key}: repeat 0 reads from inside the region")
        if stream in stream_entry:
            if stream_entry[stream] != entry:
                raise ValueError(
                    f"stream {stream}: inconsistent entry values "
                    f"({stream_entry[stream]} vs {entry})"
                )
        else:
            stream_entry[stream] = entry
            stream_order.append(stream)

    if not stream_order:
        raise ValueError("pipelined region has no rotating stream")
    rotating_in = [stream_entry[s] for s in stream_order]
    # the executor seeds the template's inputs by entry (guid, idx): the
    # keys must be pairwise distinct or two carry positions would collide
    # on one key and blocks would silently read the wrong tensor (e.g. a
    # decoder whose initial hidden state IS the shared encoder output)
    all_keys = rotating_in + shared
    if len(set(all_keys)) != len(all_keys):
        raise ValueError(
            f"boundary entry values collide (rotating {rotating_in}, "
            f"shared {shared}): inexpressible as a tuple carry"
        )

    # region outputs: whatever escapes the LAST repeat must be a rotating
    # stream position (those are banked by the schedule); the sink case
    # (no escapes) exposes all streams. A MIDDLE repeat's value escaping
    # the region (deep supervision off an intermediate block) is
    # unrecoverable — the schedule banks only the final carry — and must
    # fail HERE with ValueError so the search falls back to dp/tp, not
    # later with a KeyError in the executor.
    last_pos = rep_pos[-1]
    streams = set(stream_order)
    for j, rep in enumerate(repeats):
        is_last = j == len(repeats) - 1
        ok_dsts = rep_guids[j] if is_last else rep_guids[j] | rep_guids[j + 1]
        for node in rep:
            for e in graph.out_edges(node):
                if e.dst in ok_dsts:
                    continue
                if is_last:
                    if (last_pos[node.guid], e.src_idx) not in streams:
                        raise ValueError(
                            f"last repeat exposes {(node.guid, e.src_idx)} at "
                            f"position {(last_pos[node.guid], e.src_idx)}, "
                            "which is not a rotating stream"
                        )
                else:
                    raise ValueError(
                        f"repeat {j} value {(node.guid, e.src_idx)} escapes the "
                        "pipelined region mid-stack (only the final carry is "
                        "banked)"
                    )
    return rotating_in, shared, stream_order


def balanced_stages(costs, n_stages: int):
    """Split op costs into contiguous stages minimizing the max stage cost
    (the placement half of pipeline parallelism; reference analog: the DP
    search's sequential graph splits, graph.cc:206-231). Returns stage
    boundary indices: ops [b[i], b[i+1]) form stage i."""
    n = len(costs)
    if n_stages <= 1 or n <= n_stages:
        bounds = list(range(n + 1))
        while len(bounds) < n_stages + 1:
            bounds.append(n)
        return bounds[: n_stages + 1]
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def stage_cost(i, j):
        return prefix[j] - prefix[i]

    # binary search the max stage cost, greedy feasibility
    lo, hi = max(costs), prefix[-1]
    for _ in range(40):
        mid = (lo + hi) / 2
        stages, start = 1, 0
        for i in range(1, n + 1):
            if stage_cost(start, i) > mid:
                stages += 1
                start = i - 1
        if stages <= n_stages:
            hi = mid
        else:
            lo = mid
    # materialize bounds at threshold hi
    bounds = [0]
    start = 0
    for i in range(1, n + 1):
        if stage_cost(start, i) > hi and len(bounds) < n_stages:
            bounds.append(i - 1)
            start = i - 1
    bounds.append(n)
    while len(bounds) < n_stages + 1:
        bounds.insert(-1, bounds[-2])
    return bounds
