"""Stage discovery: the repeated block structure of a graph (port of
``_node_signatures``, ``_blocks_equal`` and ``detect_repeats`` from
``flexflow_tpu/parallel/pipeline.py``).

The executor's rematerialization (``FFConfig.remat_blocks``) wraps each
repeated block in ``torch.utils.checkpoint``. The GPipe schedule that
the JAX package also builds on these blocks waits for the multi-GPU
slices.
"""
from __future__ import annotations


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
