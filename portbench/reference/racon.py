"""racon's polishing and correction semantics in plain Python and numpy,
for the benchmark's check. Imports nothing of the program.

From the files the benchmark wrote (two-line FASTA, PAF or SAM) it
computes what racon's `Polisher` computes (src/polisher.cpp:165-548):
the overlaps that survive its filters, the windows of every target, the
layers of chosen windows (the overlaps aligned here, or their CIGARs
walked, and cut at window boundaries), each chosen window's consensus
(`poa.consensus_window`, with the cuda path's cap of layers a window),
and the stitched records of a whole job from given per-window answers.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import align, poa

_RC = bytes.maketrans(b"ACGT", b"TGCA")


def read_fasta(path: str) -> list[tuple[bytes, bytes]]:
    """(name, sequence) of each record of a FASTA file (the name is the
    header up to its first space)."""
    out = []
    name, parts = None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, b"".join(parts)))
                name, parts = line[1:].split(b" ")[0], []
            elif line:
                parts.append(line)
    if name is not None:
        out.append((name, b"".join(parts)))
    return out


@dataclass
class Overlap:
    q: bytes
    t: bytes
    q_begin: int
    q_end: int
    q_length: int
    t_begin: int
    t_end: int
    strand: bool
    length: int
    error: float
    valid: bool = True
    cigar: bytes = b""


def read_overlaps(path: str) -> list[Overlap]:
    """PAF (12 columns) or SAM records, in file order."""
    out = []
    sam = path.endswith(".sam")
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if not line or line.startswith(b"@"):
                continue
            c = line.split(b"\t")
            if sam:
                flag = int(c[1])
                strand = bool(flag & 0x10)
                tb = int(c[3]) - 1
                qb, qe, ql, te, ln, err = align.sam_accounting(c[5], strand,
                                                               tb)
                out.append(Overlap(c[0], c[2], qb, qe, ql, tb, te, strand,
                                   ln, err, not flag & 0x4, c[5]))
            else:
                qb, qe, tb, te = int(c[2]), int(c[3]), int(c[7]), int(c[8])
                ln = max(qe - qb, te - tb)
                err = 1.0 - min(qe - qb, te - tb) / ln if ln else 1.0
                out.append(Overlap(c[0], c[5], qb, qe, int(c[1]), tb, te,
                                   c[4] == b"-", ln, err))
    return out


def _kc_scan(lengths, bad) -> list[bool]:
    """racon's sequential scan of one query's run of overlaps: a bad
    record drops when reached but competes for "longest" until then; a
    record is kept when it out-lengths every later living one."""
    n = len(lengths)
    alive = [True] * n
    keep = [False] * n
    for i in range(n):
        if not alive[i]:
            continue
        if bad[i]:
            alive[i] = False
            continue
        won = True
        for j in range(i + 1, n):
            if not alive[j]:
                continue
            if lengths[i] > lengths[j]:
                alive[j] = False
            else:
                alive[i] = False
                won = False
                break
        if won:
            keep[i] = True
    return keep


@dataclass
class Job:
    """A racon job's inputs and the geometry of its windows."""
    targets: list[tuple[bytes, bytes]]
    reads: dict[bytes, bytes]
    overlaps: list[Overlap]            # after racon's filters, file order
    window_length: int
    tgs: bool
    fragment: bool
    first_window: np.ndarray = field(default=None)  # per target, + total
    source: tuple = ()  # load_job's arguments, to load it again elsewhere

    @property
    def num_windows(self) -> int:
        return int(self.first_window[-1])

    def window(self, wid: int) -> tuple[int, int]:
        """(target index, rank) of a window id."""
        t = int(np.searchsorted(self.first_window, wid, side="right")) - 1
        return t, wid - int(self.first_window[t])


def load_job(reads_path, overlaps_path, targets_path, window_length,
             error_threshold, fragment) -> Job:
    targets = read_fasta(targets_path)
    read_list = read_fasta(reads_path)
    reads = dict(read_list)
    tnames = {n: i for i, (n, _) in enumerate(targets)}
    ovl = read_overlaps(overlaps_path)
    # drop records naming an unknown sequence, then racon's filters over
    # each run of one query: error above the threshold, self overlaps,
    # and in contig mode all but the longest
    for o in ovl:
        o.valid = o.valid and o.q in reads and o.t in tnames
    kept = []
    runs: list[list[Overlap]] = []
    for o in (o for o in ovl if o.valid):
        if runs and runs[-1][0].q == o.q:
            runs[-1].append(o)
        else:
            runs.append([o])
    for run in runs:
        bad = [o.error > error_threshold or o.q == o.t for o in run]
        keep = ([not b for b in bad] if fragment
                else _kc_scan([o.length for o in run], bad))
        kept.extend(o for o, k in zip(run, keep) if k)
    total = sum(len(s) for _, s in read_list)
    tlens = np.array([len(s) for _, s in targets], np.int64)
    first = np.zeros(len(targets) + 1, np.int64)
    np.cumsum(-(-tlens // window_length), out=first[1:])
    return Job(targets, reads, kept, window_length,
               tgs=total / len(read_list) > 1000, fragment=fragment,
               first_window=first,
               source=(reads_path, overlaps_path, targets_path,
                       window_length, error_threshold, fragment))


def overlap_breaking_points(job: Job, o: Overlap) -> np.ndarray:
    """The overlap's breaking points: its CIGAR walked where it has one,
    else its global edit-distance alignment."""
    if o.cigar:
        ops = align.cigar_to_ops(o.cigar)
    else:
        data = job.reads[o.q]
        if o.strand:
            data = data[::-1].translate(_RC)
            q = data[o.q_length - o.q_end : o.q_length - o.q_begin]
        else:
            q = data[o.q_begin : o.q_end]
        tdata = job.targets[_target_index(job, o.t)][1]
        ops = align.edit_ops(q, tdata[o.t_begin : o.t_end])
    return align.breaking_points_from_ops(
        ops, o.strand, o.q_begin, o.q_end, o.q_length, o.t_begin, o.t_end,
        job.window_length)


def _target_index(job: Job, name: bytes) -> int:
    if not hasattr(job, "_tindex"):
        job._tindex = {n: i for i, (n, _) in enumerate(job.targets)}
    return job._tindex[name]


def region_layers(job: Job, t: int, rank_lo: int, rank_hi: int
                  ) -> dict[int, list[tuple[int, int, bytes]]]:
    """Layers (begin, end, bases) of windows rank_lo..rank_hi-1 of target
    t, in racon's order (by begin, ties in overlap order)."""
    w = job.window_length
    lo, hi = rank_lo * w, rank_hi * w
    name = job.targets[t][0]
    first = int(job.first_window[t])
    tlen = len(job.targets[t][1])
    layers: dict[int, list[tuple[int, int, bytes]]] = {
        first + r: [] for r in range(rank_lo, rank_hi)}
    for o in job.overlaps:
        if o.t != name or o.t_end <= lo or o.t_begin >= hi:
            continue
        data = job.reads[o.q]
        if o.strand:
            data = data[::-1].translate(_RC)
        for t_fm, q_fm, t_lm, q_lm in overlap_breaking_points(job, o):
            if q_lm - q_fm < 0.02 * w:
                continue
            rank = int(t_fm) // w
            if not rank_lo <= rank < rank_hi:
                continue
            start = rank * w
            begin, end = int(t_fm - start), int(t_lm - start - 1)
            if begin == end:
                continue
            if begin > end or end > min(w, tlen - start):
                raise ValueError("layer begin and end positions are invalid")
            layers[first + rank].append((begin, end,
                                         data[int(q_fm):int(q_lm)]))
    for wid in layers:  # stable: ties keep overlap order
        layers[wid].sort(key=lambda x: x[0])
    return layers


def window_backbone(job: Job, wid: int) -> bytes:
    t, rank = job.window(wid)
    w = job.window_length
    return job.targets[t][1][rank * w : (rank + 1) * w]


def window_consensus(job: Job, wid: int, layers, cfg: dict
                     ) -> tuple[bytes, bool]:
    """One window's consensus and polished flag, from at most
    cfg["max_window_depth"] of its layers."""
    t, rank = job.window(wid)
    use = layers[: max(1, cfg["max_window_depth"])]
    return poa.consensus_window(
        np.frombuffer(window_backbone(job, wid), np.uint8), None,
        [(np.frombuffer(d, np.uint8), None, b, e) for b, e, d in use],
        job.tgs, cfg["trim"], cfg["match"], cfg["mismatch"], cfg["gap"],
        window_id=t, rank=rank, passes=cfg["refine_passes"],
        cand_frac=cfg["candidate_frac"], cand_min=cfg["candidate_min"])


def stitch(job: Job, consensus: list[bytes], polished: list[bool],
           drop_unpolished: bool) -> list[tuple[bytes, bytes]]:
    """racon's output records (src/polisher.cpp:506-532) from the
    per-window consensus and polished flags of every window."""
    coverage: dict[bytes, int] = {}
    for o in job.overlaps:
        coverage[o.t] = coverage.get(o.t, 0) + 1
    out = []
    for t, (name, _) in enumerate(job.targets):
        lo, hi = int(job.first_window[t]), int(job.first_window[t + 1])
        if hi == lo:
            continue
        ratio = sum(bool(p) for p in polished[lo:hi]) / float(hi - lo)
        if drop_unpolished and ratio <= 0:
            continue
        data = b"".join(consensus[lo:hi])
        tags = b"r" if job.fragment else b""
        tags += b" LN:i:%d" % len(data)
        tags += b" RC:i:%d" % coverage.get(name, 0)
        tags += b" XC:f:%f" % ratio
        out.append((name + tags, data))
    return out


def identity_kf(workdir: str, records, sample: int, seed) -> dict:
    """Corrected and raw reads' identity (%) to their true source
    segments on `sample` reads drawn from the seed: a frozen copy of
    racon_tpu_torch/benchmarks/genome_scale.py's `_identity_kf` (kF
    appends 'r' to each record name), with this module's edit distance."""
    spans = np.load(f"{workdir}/true_spans.npy")
    true = read_fasta(f"{workdir}/true.fasta")[0][1]
    raws = dict(read_fasta(f"{workdir}/reads.fasta"))
    corrected = {nm.split(b" ")[0]: d for nm, d in records}
    pick = np.random.default_rng([int(seed), 3]).choice(
        len(spans), min(sample, len(spans)), replace=False)
    cd = rd = nbp = used = 0
    for r in pick:
        nm = b"r%dr" % r
        if nm not in corrected:
            continue
        seg = true[spans[r, 0]:spans[r, 1]]
        cd += align.edit_distance(corrected[nm], seg)
        rd += align.edit_distance(raws[b"r%d" % r], seg)
        nbp += len(seg)
        used += 1
    return {"identity_pct": 100.0 * (1.0 - cd / max(nbp, 1)),
            "raw_identity_pct": 100.0 * (1.0 - rd / max(nbp, 1)),
            "reads": used}
