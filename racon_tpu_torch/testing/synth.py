"""Synthetic inputs of the port's checks (numpy only): copies of the JAX
package's two generators, so the port and its smoke run need nothing of
racon_tpu. Same seeds, same bytes.

- build_workload: bench.py's consensus workload (2048 windows of 500 bp,
  depth 20, 12 % read error), as a WindowSet plus the true sequence;
- make_dataset: benchmarks/genome_scale.py's ONT-like dataset (genome,
  draft with ~1 % errors, reads and PAF overlaps written to a directory).

and one of the port's own, for racon's other input formats:

- make_cigar_dataset: a contig and reads of its truth with known edits,
  as FASTA and FASTQ reads and PAF, MHAP and SAM (with CIGARs) overlaps.
"""

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

N_WINDOWS = 2048
WINDOW_LEN = 500
DEPTH = 20
ERR = 0.12


def _mutate_read(rng, seg):
    """Vectorized ONT-like read simulation: per-base del/ins/sub at ERR."""
    r = rng.random(len(seg))
    keep = r >= ERR / 3                      # deletions
    ins = r < 2 * ERR / 3
    ins &= keep  # insertion after a kept base (matches the scalar version:
    # the branch ordering made dels and inss disjoint)
    sub = (r >= 2 * ERR / 3) & (r < ERR)
    base = seg.copy()
    base[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    # interleave: emit kept base, then an inserted random base where ins
    out_len = keep.astype(np.int64) + ins.astype(np.int64)
    off = np.zeros(len(seg) + 1, np.int64)
    np.cumsum(out_len, out=off[1:])
    read = np.empty(int(off[-1]), np.uint8)
    read[off[:-1][keep]] = base[keep]
    ipos = off[:-1][ins] + 1
    read[ipos] = ACGT[rng.integers(0, 4, len(ipos))]
    return read


def build_workload(seed=1234, n_windows=None, window_len=None):
    from ..core.store import SequenceStore
    from ..core.windows import WINDOW_TYPE_TGS, WindowSet

    n_windows = n_windows or N_WINDOWS
    window_len = window_len or WINDOW_LEN
    rng = np.random.default_rng(seed)
    glen = n_windows * window_len
    true = rng.choice(ACGT, glen)
    draft = true.copy()
    # draft errors: subs + deletions (ONT-like draft)
    for pos in rng.choice(glen, glen // 50, replace=False):
        draft[pos] = rng.choice(ACGT)
    keep = np.delete(np.arange(glen), rng.choice(glen, glen // 100,
                                                 replace=False))
    draft = draft[keep]  # keep[i] = true-coordinate of draft position i

    # store: target (draft) + reads
    names = [b"ctg"]
    parts = [draft]
    qid = 1
    # reads tile the target; each read ~2kb covering 4 windows, staggered
    # so every window sees ~DEPTH layers (read coverage = read_len/step).
    # NOTE (round 2): step was read_len_t // (DEPTH // 4), which yields ~6
    # layers/window, not the advertised 20 — numbers before this fix are a
    # ~6-deep workload and are NOT comparable (see PLAN.md M14).
    # read r spans draft[start:end]; its error-free source is the matching
    # true-coordinate slice (keep[] maps between the two systems)
    read_len_t = 4 * window_len
    step = max(1, read_len_t // DEPTH)
    for start in range(0, len(draft) - 100, step):
        end = min(start + read_len_t, len(draft))
        seg = true[keep[start] : keep[end - 1] + 1]
        read = _mutate_read(rng, seg)
        names.append(b"r%d" % qid)
        parts.append(read)
        qid += 1

    data_off = np.zeros(len(parts) + 1, np.int64)
    for i, p in enumerate(parts):
        data_off[i + 1] = data_off[i] + len(p)
    store = SequenceStore(names, np.concatenate(parts), data_off,
                          np.zeros(0, np.uint8),
                          np.zeros(len(parts) + 1, np.int64))

    windows = WindowSet(store, 1, window_len, WINDOW_TYPE_TGS)
    # assign layers via the host aligner's breaking points (setup, not timed)
    from ..native import bindings

    n_reads = len(parts) - 1
    qoff = np.zeros(n_reads + 1, np.int64)
    toff = np.zeros(n_reads + 1, np.int64)
    spans = []
    for r in range(n_reads):
        read = parts[r + 1]
        tb = min(int(r * step), len(draft) - 1)
        te = min(tb + read_len_t, len(draft))
        spans.append((tb, te))
        qoff[r + 1] = qoff[r] + len(read)
        toff[r + 1] = toff[r] + (te - tb)
    quads, quad_off, counts = bindings.breaking_points_batch(
        np.concatenate(parts[1:]),
        qoff, np.concatenate([draft[b:e] for b, e in spans]), toff,
        np.zeros(n_reads, np.uint8), np.zeros(n_reads, np.int64),
        qoff[1:] - qoff[:-1], qoff[1:] - qoff[:-1],
        np.array([b for b, _ in spans], np.int64),
        np.array([e for _, e in spans], np.int64), window_len, 16)
    for r in range(n_reads):
        o = int(quad_off[r])
        bp = quads[o : o + int(counts[r])]
        windows.assign_overlap(bp, r + 1, 0, False, 10.0)
    windows.freeze()
    return windows, true


def make_dataset(workdir, genome_bp, read_len, coverage, err, seed=11,
                 mix=(1 / 3, 1 / 3, 1 / 3), chimeric_frac=0.0,
                 ava=False):
    """Synthetic ONT-like dataset. chimeric_frac > 0 makes that fraction
    of reads chimeras — the tail ~40% of the read comes from a distant
    genome locus while the PAF maps only the head segment (what a real
    mapper reports after clipping): the junction floods its windows with
    misaligned layers, exercising the kTGS coverage trim
    (reference src/window.cpp:118-139) and the quality/span filters.
    ava=True additionally writes reads-vs-reads overlaps (ava.paf, from
    the known sampling intervals) and true_spans.npy (per-read true
    genome interval) for fragment-correction (kF) benchmarking."""
    rng = np.random.default_rng(seed)
    true = rng.choice(ACGT, genome_bp)
    with open(os.path.join(workdir, "true.fasta"), "wb") as f:
        f.write(b">true\n" + true.tobytes() + b"\n")

    # draft: ~0.7% subs + 0.3% dels
    draft = true.copy()
    subs = rng.choice(genome_bp, int(genome_bp * 0.007), replace=False)
    draft[subs] = rng.choice(ACGT, len(subs))
    keep = np.delete(np.arange(genome_bp),
                     rng.choice(genome_bp, int(genome_bp * 0.003),
                                replace=False))
    draft = draft[keep]  # keep[i] = true coord of draft position i
    dlen = len(draft)

    n_reads = int(genome_bp * coverage / read_len)
    starts = rng.integers(0, dlen - read_len, n_reads)
    reads_f = open(os.path.join(workdir, "reads.fasta"), "wb")
    paf_f = open(os.path.join(workdir, "ovl.paf"), "wb")
    ins_p = err * mix[0]
    del_p = err * mix[1]
    n_chim = int(n_reads * chimeric_frac)
    chim = np.zeros(n_reads, bool)
    if n_chim:
        chim[rng.choice(n_reads, n_chim, replace=False)] = True
    read_lens = np.zeros(n_reads, np.int64)
    map_spans = np.zeros((n_reads, 2), np.int64)  # draft coords of the
    # MAPPED head segment

    def noisy(src):
        u = rng.random(len(src))
        ins_mask = u < ins_p
        del_mask = (u >= ins_p) & (u < ins_p + del_p)
        sub_mask = (u >= ins_p + del_p) & (u < err)
        out = src.copy()
        out[sub_mask] = rng.choice(ACGT, int(sub_mask.sum()))
        # a random base after each insertion point: one draw of them all
        # takes the generator's stream exactly as a draw per base would
        ins_at = np.flatnonzero(ins_mask)
        read = np.insert(out, ins_at + 1, rng.choice(ACGT, len(ins_at)))
        # apply deletions on a mask projected through insertions is
        # fiddly; approximate by deleting from the assembled read
        dmask = np.ones(len(read), bool)
        dmask[rng.choice(len(read), int(del_mask.sum()),
                         replace=False)] = False
        return read[dmask]

    for r in range(n_reads):
        s = int(starts[r])
        if chim[r]:
            # chimera: head ~60% maps at s, tail from a distant locus;
            # only the head is reported in the PAF (mapper clip behavior)
            head_bp = int(read_len * 0.6)
            e = s + head_bp
            s2 = int(rng.integers(0, dlen - read_len))
            head = noisy(true[keep[s] : keep[e - 1] + 1])
            tail = noisy(true[keep[s2] : keep[s2 + read_len - head_bp - 1]
                              + 1])
            read = np.concatenate([head, tail])
            q_end = len(head)
        else:
            e = s + read_len
            read = noisy(true[keep[s] : keep[e - 1] + 1])
            q_end = len(read)
        name = b"r%d" % r
        reads_f.write(b">" + name + b"\n" + read.tobytes() + b"\n")
        paf_f.write(b"\t".join([
            name, b"%d" % len(read), b"0", b"%d" % q_end, b"+",
            b"ctg", b"%d" % dlen, b"%d" % s, b"%d" % e, b"1", b"1",
            b"60"]) + b"\n")
        read_lens[r] = len(read)
        map_spans[r] = (s, e)
    reads_f.close()
    paf_f.close()
    with open(os.path.join(workdir, "draft.fasta"), "wb") as f:
        f.write(b">ctg\n" + draft.tobytes() + b"\n")

    if ava:
        # reads-vs-reads overlaps from the known draft intervals (kF
        # fragment-correction input; reference test scale:
        # test/racon_test.cpp:238-290). Coordinates are interval
        # intersections scaled to read lengths — the align stage
        # realigns, the drift tiers absorb the approximation.
        order = np.argsort(map_spans[:, 0], kind="stable")
        with open(os.path.join(workdir, "ava.paf"), "wb") as av:
            for oi, r in enumerate(order):
                s1, e1 = map_spans[r]
                l1 = read_lens[r]
                for r2 in order[oi + 1 :]:
                    s2, e2 = map_spans[r2]
                    if s2 >= e1 - 500:
                        break
                    ov_s, ov_e = max(s1, s2), min(e1, e2)
                    q_b = int((ov_s - s1) * l1 / (e1 - s1))
                    q_e = int((ov_e - s1) * l1 / (e1 - s1))
                    l2 = read_lens[r2]
                    t_b = int((ov_s - s2) * l2 / (e2 - s2))
                    t_e = int((ov_e - s2) * l2 / (e2 - s2))
                    av.write(b"\t".join([
                        b"r%d" % r, b"%d" % l1, b"%d" % q_b, b"%d" % q_e,
                        b"+", b"r%d" % r2, b"%d" % l2, b"%d" % t_b,
                        b"%d" % t_e, b"1", b"1", b"60"]) + b"\n")
        np.save(os.path.join(workdir, "true_spans.npy"),
                np.stack([keep[map_spans[:, 0]],
                          keep[np.minimum(map_spans[:, 1] - 1,
                                          dlen - 1)] + 1], axis=1))
    return true


def _edited(rng, seg, err):
    """seg with a substitution, an insertion (before the base) or a
    deletion at err/3 each per base, never at its two ends; returns (read,
    CIGAR of the read against seg)."""
    u = rng.random(len(seg))
    u[[0, -1]] = 1.0
    dele = u < err / 3
    ins = (u >= err / 3) & (u < 2 * err / 3)
    base = seg.copy()
    sub = (u >= 2 * err / 3) & (u < err)
    base[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    # per base: "D"; or "I" then "M"; or "M"
    n_ops = 1 + ins
    first = np.zeros(len(seg) + 1, np.int64)
    np.cumsum(n_ops, out=first[1:])
    ops = np.full(int(first[-1]), ord("M"), np.uint8)
    ops[first[:-1][dele]] = ord("D")
    ops[first[:-1][ins]] = ord("I")
    out = np.empty(len(ops), np.uint8)
    out[ops == ord("I")] = ACGT[rng.integers(0, 4, int(ins.sum()))]
    out[first[1:] - 1] = base
    read = out[ops != ord("D")]
    cuts = np.flatnonzero(np.r_[True, ops[1:] != ops[:-1], True])
    cigar = b"".join(b"%d%c" % (b - a, ops[a])
                     for a, b in zip(cuts[:-1], cuts[1:]))
    return read, cigar


def make_cigar_dataset(workdir, genome_bp, read_len, coverage, err,
                       seed=7):
    """A contig and reads of its truth with known edits, for racon's other
    input formats. Writes into `workdir`: true.fasta; draft.fasta (the
    truth with a substitution every 75 bases on average, no indels, so
    the truth's coordinates are the draft's); the reads (`coverage` x
    genome_bp / read_len of them, read_len bases of the truth each at
    `err`, every 3rd stored reverse-complemented, every 4th forward one
    behind a 7 bp soft clip) as reads.fasta and as reads.fastq (quality
    40, and 2 over the first half of every 5th read, so -q 10 drops its
    layers there); and each read's overlap with the draft as ovl.paf,
    ovl.mhap (no CIGAR) and ovl.sam (the CIGAR of its known edits).
    Returns the truth."""
    rng = np.random.default_rng(seed)
    true = rng.choice(ACGT, genome_bp)
    draft = true.copy()
    subs = rng.choice(genome_bp, genome_bp // 75, replace=False)
    draft[subs] = ACGT[rng.integers(0, 4, len(subs))]
    fasta, fastq, paf, mhap = [], [], [], []
    sam = [b"@HD\tVN:1.6\n@SQ\tSN:ctg\tLN:%d\n" % genome_bp]
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    for r in range(genome_bp * coverage // read_len):
        s = int(rng.integers(0, genome_bp - read_len + 1))
        e = s + read_len
        read, cigar = _edited(rng, true[s:e], err)
        rev = r % 3 == 1
        clip = 0 if rev or r % 4 != 2 else 7
        if clip:
            read = np.concatenate([rng.choice(ACGT, clip), read])
            cigar = b"%dS" % clip + cigar
        data = read.tobytes()[::-1].translate(rc) if rev else read.tobytes()
        n = len(data)
        qual = bytearray(b"I" * n)
        if r % 5 == 0:
            qual[: n // 2] = b"#" * (n // 2)
        name = b"read%d" % r
        fasta.append(b">%s\n%s\n" % (name, data))
        fastq.append(b"@%s\n%s\n+\n%s\n" % (name, data, bytes(qual)))
        paf.append(b"%s\t%d\t%d\t%d\t%c\tctg\t%d\t%d\t%d\t9\t9\t60\n"
                   % (name, n, clip, n, b"-+"[not rev], genome_bp, s, e))
        mhap.append(b"%d 1 0.1 9 %d %d %d %d 0 %d %d %d\n"
                    % (r + 1, rev, clip, n, n, s, e, genome_bp))
        sam.append(b"%s\t%d\tctg\t%d\t60\t%s\t*\t0\t0\t*\t*\n"
                   % (name, 16 if rev else 0, s + 1, cigar))
    for name, parts in (("reads.fasta", fasta), ("reads.fastq", fastq),
                        ("ovl.paf", paf), ("ovl.mhap", mhap),
                        ("ovl.sam", sam)):
        with open(os.path.join(workdir, name), "wb") as f:
            f.write(b"".join(parts))
    for name, seq in (("true.fasta", true), ("draft.fasta", draft)):
        with open(os.path.join(workdir, name), "wb") as f:
            f.write(b">%s\n%s\n" % (b"true" if name[0] == "t" else b"ctg",
                                    seq.tobytes()))
    return true
