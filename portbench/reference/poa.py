"""Star partial-order consensus of one window, in plain numpy and Python:
a frozen copy of racon_tpu_torch/ops/poa_host.py (the star-POA with
iterative refinement that the port's native merge and device alignments
compute) and of the linear-gap Needleman-Wunsch of ops/nw_host.py that it
aligns each layer with (traceback preference DIAG, then UP, then LEFT).
Imports nothing of the program.
"""

from __future__ import annotations

import sys

import numpy as np

OP_MATCH = 0  # consumes query and target
OP_INS = 1    # consumes query
OP_DEL = 2    # consumes target

NEG_INF = -(1 << 29)


def nw_align(query: np.ndarray, target: np.ndarray, match: int, mismatch: int,
             gap: int, del_cost: np.ndarray | None = None
             ) -> tuple[int, np.ndarray]:
    """Global alignment; returns (score, ops) with ops rows (op, run).

    del_cost, when given, is the per-target-column cost of consuming t[j] by
    deletion (normally `gap`; 0 marks the refinement passes' "optional"
    columns). The horizontal closure generalizes the max-plus prefix scan to
    cumulative costs Gc: H[i,j] = Gc[j] + max_{k<=j}(cand[i,k] - Gc[k]).
    """
    q = np.asarray(query, dtype=np.uint8)
    t = np.asarray(target, dtype=np.uint8)
    m, n = len(q), len(t)
    if del_cost is None:
        del_cost = np.full(n, gap, dtype=np.int32)
    Gc = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(del_cost, out=Gc[1:])
    H = np.empty((m + 1, n + 1), dtype=np.int32)
    H[0] = Gc
    for i in range(1, m + 1):
        sub_row = np.where(t == q[i - 1], np.int32(match), np.int32(mismatch))
        cand = np.empty(n + 1, dtype=np.int32)
        cand[0] = i * gap
        # diag and up candidates
        np.maximum(H[i - 1, :n] + sub_row, H[i - 1, 1:] + gap, out=cand[1:])
        # horizontal closure via max-plus prefix scan
        H[i] = np.maximum.accumulate(cand - Gc) + Gc
    score = int(H[m, n])

    # traceback, re-deriving moves from H (DIAG > UP > LEFT)
    ops: list[tuple[int, int]] = []
    i, j = m, n
    while i > 0 or j > 0:
        h = H[i, j]
        if i > 0 and j > 0 and h == H[i - 1, j - 1] + (
                match if q[i - 1] == t[j - 1] else mismatch):
            op = OP_MATCH
            i -= 1
            j -= 1
        elif i > 0 and h == H[i - 1, j] + gap:
            op = OP_INS
            i -= 1
        else:
            op = OP_DEL
            j -= 1
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    ops.reverse()
    return score, np.asarray(ops, dtype=np.int32).reshape(-1, 2)


def nw_align_batch(items, match: int, mismatch: int, gap: int
                   ) -> list[np.ndarray]:
    """nw_align's ops of each (query, target, del_cost) in `items`, the
    row recurrence run once for all of them: each item padded to the
    longest query and target, which leaves its own cells' values as
    nw_align computes them (a cell reads only cells above and to its
    left). Each cell keeps the two tests of nw_align's traceback (the
    diagonal and the up move reproduce its value), and each item is then
    traced back from its own corner with nw_align's preference."""
    if not items:
        return []
    B = len(items)
    m = max(len(q) for q, _, _ in items)
    n = max(len(t) for _, t, _ in items)
    Q = np.full((B, m), 255, np.uint8)  # pads never equal a base
    T = np.full((B, n), 254, np.uint8)
    Gc = np.zeros((B, n + 1), np.int32)
    for b, (q, t, dc) in enumerate(items):
        Q[b, :len(q)] = q
        T[b, :len(t)] = t
        np.cumsum(np.asarray(dc, np.int32), out=Gc[b, 1:len(t) + 1])
        Gc[b, len(t) + 1:] = Gc[b, len(t)]
    # bit 1: the diagonal move reproduces the cell; bit 2: the up move
    moves = np.zeros((B, m + 1, n + 1), np.uint8)
    prev = Gc.copy()
    cand = np.empty((B, n + 1), np.int32)
    for i in range(1, m + 1):
        sub = np.where(T == Q[:, i - 1:i], np.int32(match),
                       np.int32(mismatch))
        diag = prev[:, :n] + sub
        up = prev + np.int32(gap)
        cand[:, 0] = i * gap
        np.maximum(diag, up[:, 1:], out=cand[:, 1:])
        row = np.maximum.accumulate(cand - Gc, axis=1) + Gc
        moves[:, i, 1:] = row[:, 1:] == diag
        moves[:, i] |= (row == up).view(np.uint8) << 1
        prev = row
    out = []
    w = n + 1
    for b, (q, t, _) in enumerate(items):
        mq, nt = len(q), len(t)
        mv = memoryview(moves[b].reshape(-1))
        ops: list[list[int]] = []
        i, j = mq, nt
        while i > 0 or j > 0:
            c = mv[i * w + j]
            if i > 0 and j > 0 and c & 1:
                op = OP_MATCH
                i -= 1
                j -= 1
            elif i > 0 and c & 2:
                op = OP_INS
                i -= 1
            else:
                op = OP_DEL
                j -= 1
            if ops and ops[-1][0] == op:
                ops[-1][1] += 1
            else:
                ops.append([op, 1])
        ops.reverse()
        out.append(np.asarray(ops, dtype=np.int32).reshape(-1, 2))
    return out


class StarGraph:
    def __init__(self, backbone: np.ndarray, backbone_weights: np.ndarray):
        w = len(backbone)
        self.backbone_len = w
        self.base = list(int(b) for b in backbone)
        self.coverage = [0] * w
        self.node_col = list(range(w))      # backbone column of node, -1 = insertion
        self.ring: dict[tuple[int, int], int] = {}      # (col, base) -> node
        self.col_variants: list[list[int]] = [[] for _ in range(w)]
        # insertion nodes are column-aligned per gap: keyed (gap, depth, base)
        # so identical inserted bases from different layers share one node and
        # votes concentrate (the role graph alignment plays in sequential POA)
        self.ins_node: dict[tuple[int, int, int], int] = {}
        self.ins_levels: list[list[list[int]]] = [[] for _ in range(w + 1)]
        self.in_edges: list[list[int]] = [[] for _ in range(w)]   # per node: edge ids
        self.out_edges: list[list[int]] = [[] for _ in range(w)]
        self.edge_tail: list[int] = []
        self.edge_head: list[int] = []
        self.edge_weight: list[int] = []
        self.edge_index: dict[tuple[int, int], int] = {}
        self.node_slot: list[int] = list(range(w))  # ordering slot (see _rank)

        # add the backbone itself as the first path (label 0)
        bw = backbone_weights
        for c in range(w):
            self.coverage[c] += 1
            if c > 0:
                self._bump_edge(c - 1, c, int(bw[c - 1]) + int(bw[c]))

    # ------------------------------------------------------------------ #

    def _new_node(self, base: int, col: int, slot: int) -> int:
        nid = len(self.base)
        self.base.append(base)
        self.coverage.append(0)
        self.node_col.append(col)
        self.in_edges.append([])
        self.out_edges.append([])
        self.node_slot.append(slot)
        return nid

    def _bump_edge(self, u: int, v: int, w: int) -> None:
        eid = self.edge_index.get((u, v))
        if eid is None:
            eid = len(self.edge_tail)
            self.edge_tail.append(u)
            self.edge_head.append(v)
            self.edge_weight.append(w)
            self.edge_index[(u, v)] = eid
            self.out_edges[u].append(eid)
            self.in_edges[v].append(eid)
        else:
            self.edge_weight[eid] += w

    def add_path(self, ops: np.ndarray, t_offset: int, data: np.ndarray,
                 weights: np.ndarray) -> None:
        """Merge one layer's backbone alignment into the graph."""
        prev = -1
        q = 0
        t = t_offset
        ins_depth = 0  # consecutive inserted bases since last match/deletion
        for k in range(len(ops)):
            op, run = int(ops[k, 0]), int(ops[k, 1])
            if op != OP_INS:
                ins_depth = 0
            if op == OP_MATCH:
                for _ in range(run):
                    b = int(data[q])
                    if self.base[t] == b:
                        node = t
                    else:
                        node = self.ring.get((t, b))
                        if node is None:
                            node = self._new_node(b, t, t)
                            self.ring[(t, b)] = node
                            self.col_variants[t].append(node)
                    self.coverage[node] += 1
                    if prev >= 0:
                        self._bump_edge(prev, node,
                                        int(weights[q - 1]) + int(weights[q]))
                    prev = node
                    q += 1
                    t += 1
            elif op == OP_INS:
                for _ in range(run):
                    b = int(data[q])
                    depth = ins_depth
                    ins_depth += 1
                    node = self.ins_node.get((t, depth, b))
                    if node is None:
                        node = self._new_node(b, -1, t)
                        self.ins_node[(t, depth, b)] = node
                        levels = self.ins_levels[t]
                        while len(levels) <= depth:
                            levels.append([])
                        levels[depth].append(node)
                    self.coverage[node] += 1
                    if prev >= 0:
                        self._bump_edge(prev, node,
                                        int(weights[q - 1]) + int(weights[q]))
                    prev = node
                    q += 1
            else:  # OP_DEL
                t += run

    # ------------------------------------------------------------------ #

    def _rank(self) -> list[int]:
        """Topological order: per backbone slot, the insertion columns of the
        preceding gap (by depth, then creation), then the column group
        (backbone node + variants). Edges only flow gap-depth-forward /
        column-forward, so this is a valid topo order."""
        order: list[int] = []
        for c in range(self.backbone_len):
            for level in self.ins_levels[c]:
                order.extend(level)
            order.append(c)
            order.extend(self.col_variants[c])
        for level in self.ins_levels[self.backbone_len]:
            order.extend(level)
        return order

    def consensus(self) -> tuple[bytes, np.ndarray]:
        data, cov, _ = self.consensus_path()
        return data, cov

    def node_slot_of(self, v: int) -> int:
        """Backbone slot of a node: its column, or the gap index for
        insertion nodes (used to project layer coordinates onto a new
        backbone between refinement passes)."""
        return self.node_slot[v]

    def consensus_path(self) -> tuple[bytes, np.ndarray, np.ndarray]:
        """Heaviest-bundle consensus + per-base column coverage + node slots
        (spoa semantics: TraverseHeaviestBundle + BranchCompletion)."""
        n = len(self.base)
        rank = self._rank()
        node_rank = [0] * n
        for r, v in enumerate(rank):
            node_rank[v] = r
        scores = [-1] * n
        pred = [-1] * n

        best = -1
        for v in rank:
            for eid in self.in_edges[v]:
                u, w = self.edge_tail[eid], self.edge_weight[eid]
                if scores[v] < w or (scores[v] == w and
                                     scores[pred[v]] <= scores[u]):
                    scores[v] = w
                    pred[v] = u
            if pred[v] >= 0:
                scores[v] += scores[pred[v]]
            if best < 0 or scores[best] < scores[v]:
                best = v

        # branch completion: if the heaviest path ends mid-graph, rescore the
        # downstream subgraph banning side-branches of the current tip
        while self.out_edges[best]:
            tip_rank = node_rank[best]
            for eid in self.out_edges[best]:
                head = self.edge_head[eid]
                for eid2 in self.in_edges[head]:
                    tail = self.edge_tail[eid2]
                    if tail != best:
                        scores[tail] = -1
            max_score = 0
            max_node = -1
            for r in range(tip_rank + 1, n):
                v = rank[r]
                scores[v] = -1
                pred[v] = -1
                for eid in self.in_edges[v]:
                    u, w = self.edge_tail[eid], self.edge_weight[eid]
                    if scores[u] == -1:
                        continue
                    if scores[v] < w or (scores[v] == w and
                                         scores[pred[v]] <= scores[u]):
                        scores[v] = w
                        pred[v] = u
                if pred[v] >= 0:
                    scores[v] += scores[pred[v]]
                if max_score < scores[v]:
                    max_score = scores[v]
                    max_node = v
            if max_node < 0:
                break
            best = max_node

        path = []
        v = best
        while v >= 0:
            path.append(v)
            v = pred[v]
        path.reverse()
        self.last_path = path

        data = bytes(self.base[v] for v in path)
        cov = np.empty(len(path), dtype=np.int64)
        slots = np.empty(len(path), dtype=np.int64)
        for i, v in enumerate(path):
            c = self.coverage[v]
            col = self.node_col[v]
            if col >= 0:
                ring = self.col_variants[col]
                c += sum(self.coverage[x] for x in ring if x != v)
                if v != col:
                    c += self.coverage[col]
            cov[i] = c
            slots[i] = self.node_slot[v]
        return data, cov, slots


def expanded_backbone(graph: StarGraph, path_bases: bytes,
                      path_slots: np.ndarray, path_nodes: list[int],
                      n_layers: int, gap: int, cand_frac: float,
                      cand_min: int, max_len: int):
    """Consensus path + off-path insertion candidates (support >= threshold)
    as zero-deletion-cost optional columns. Returns (seq, del_cost, slots)
    where slots index the graph's backbone coordinates."""
    thr = max(cand_min, int(cand_frac * n_layers))
    on_path = set(path_nodes)
    n_slots = graph.backbone_len + 1
    cand: dict[int, list[int]] = {}
    for s in range(n_slots):
        for level in graph.ins_levels[s]:
            best = -1
            for v in level:
                if v in on_path:
                    continue
                if graph.coverage[v] >= thr and (
                        best < 0 or graph.coverage[v] > graph.coverage[best]):
                    best = v
            if best >= 0:
                cand.setdefault(s, []).append(graph.base[best])
    seq = bytearray()
    del_cost: list[int] = []
    slots: list[int] = []
    next_cand = 0

    def emit_upto(s):
        nonlocal next_cand
        while next_cand <= s and next_cand < n_slots:
            for b in cand.get(next_cand, ()):
                if len(seq) >= max_len:
                    break
                seq.append(b)
                del_cost.append(0)
                slots.append(next_cand)
            next_cand += 1

    for i, v in enumerate(path_nodes):
        s = int(path_slots[i])
        emit_upto(s)
        if len(seq) >= max_len:
            break
        seq.append(graph.base[v])
        del_cost.append(gap)
        slots.append(s)
    emit_upto(n_slots - 1)
    return (bytes(seq), np.asarray(del_cost, np.int32),
            np.asarray(slots, np.int64))


def consensus_window(backbone: np.ndarray, backbone_qual: np.ndarray | None,
                     layers: list[tuple[np.ndarray, np.ndarray | None, int, int]],
                     window_type_tgs: bool, trim: bool, match: int,
                     mismatch: int, gap: int,
                     window_id: int = 0, rank: int = 0,
                     passes: int = 4, cand_frac: float = 0.15,
                     cand_min: int = 2) -> tuple[bytes, bool]:
    """Generate one window's consensus with iterative refinement.

    layers: (data, quality_or_None, begin, end) sorted by begin; begin/end are
    inclusive ORIGINAL-backbone coordinates (reference: src/window.cpp:65-142).
    Pass 1 aligns layers to the raw backbone; between passes the backbone is
    replaced by the consensus expanded with high-support off-path insertion
    candidates as zero-deletion-cost optional columns, so the next pass's
    alignments can match them (the role progressive graph alignment plays in
    the reference's spoa engine). Returns (consensus, polished).
    """
    if len(layers) < 2:
        return backbone.tobytes(), False
    w0 = len(backbone)
    cur = np.asarray(backbone)
    cur_bw = (backbone_qual.astype(np.int32) - 33
              if backbone_qual is not None else np.zeros(w0, dtype=np.int32))
    cur_del = np.full(w0, gap, dtype=np.int32)
    cur_slots = np.arange(w0, dtype=np.int64)
    lay_weights = []
    for data, qual, _, _ in layers:
        lay_weights.append(qual.astype(np.int32) - 33 if qual is not None
                           else np.ones(len(data), dtype=np.int32))

    for ps in range(max(1, passes)):
        final = ps == max(1, passes) - 1
        graph = StarGraph(cur, cur_bw)
        n = len(cur)
        offset = 0.01 * n
        spans = []
        for data, _, begin, end in layers:
            b2 = int(np.searchsorted(cur_slots, begin, side="left"))
            e2 = int(np.searchsorted(cur_slots, end, side="right")) - 1
            b2 = max(0, min(b2, n - 1))
            e2 = max(b2, min(e2, n - 1))
            if b2 < offset and e2 > n - offset:
                b2, e2 = 0, n - 1
            spans.append((b2, e2))
        # a pass aligns every layer to the same backbone: all at once
        all_ops = nw_align_batch(
            [(data, cur[b2:e2 + 1], cur_del[b2:e2 + 1])
             for (data, _, _, _), (b2, e2) in zip(layers, spans)],
            match, mismatch, gap)
        for (data, _, _, _), (b2, _), weights, ops in zip(
                layers, spans, lay_weights, all_ops):
            graph.add_path(ops, b2, data, weights)
        consensus, coverage, slots = graph.consensus_path()
        if not final:
            path = graph.last_path
            seq, cur_del, local_slots = expanded_backbone(
                graph, consensus, slots, path, len(layers), gap, cand_frac,
                cand_min, max_len=2 * len(cur_slots) + 64)
            cur = np.frombuffer(seq, np.uint8)
            cur_bw = np.zeros(len(cur), dtype=np.int32)
            cur_slots = cur_slots[np.minimum(local_slots, len(cur_slots) - 1)]
            continue
        if window_type_tgs and trim:
            average = len(layers) // 2
            begin = 0
            end = len(consensus) - 1
            while begin < len(consensus) and coverage[begin] < average:
                begin += 1
            while end >= 0 and coverage[end] < average:
                end -= 1
            if begin >= end:
                sys.stderr.write(
                    "[racon::Window::generate_consensus] warning: contig %d "
                    "might be chimeric in window %d!\n" % (window_id, rank))
            else:
                consensus = consensus[begin : end + 1]
        return consensus, True
