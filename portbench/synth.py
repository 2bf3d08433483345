"""The benchmark's input generators (numpy only), frozen here so that a
change to the program cannot move the yardstick.

- make_dataset: a copy of racon_tpu_torch/testing/synth.py's
  make_dataset (the genome-scale records' generator; the same bytes for
  the same arguments): a random genome, a draft with ~0.7 %
  substitutions and ~0.3 % deletions, ONT-like reads of it at `err`
  (insertions, deletions, substitutions in `mix`) and their PAF
  overlaps from the true placements; with ava=True also the reads'
  all-vs-all overlaps (ava.paf) for fragment correction.
- make_sam_dataset: the same genome, draft and read counts, with each
  read's overlap as a SAM record carrying the CIGAR of its known edits
  against the draft (make_cigar_dataset's read model, strands and soft
  clips, without its FASTQ and MHAP files).
"""

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def make_dataset(workdir, genome_bp, read_len, coverage, err, seed=11,
                 mix=(1 / 3, 1 / 3, 1 / 3), ava=False):
    """Synthetic ONT-like dataset. ava=True additionally writes
    reads-vs-reads overlaps (ava.paf, from the known sampling intervals)
    and true_spans.npy (per-read true genome interval) for
    fragment-correction (kF) benchmarking."""
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
    read_lens = np.zeros(n_reads, np.int64)
    map_spans = np.zeros((n_reads, 2), np.int64)  # draft coords

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
    """make_cigar_dataset's read model: seg with a substitution, an
    insertion (before the base) or a deletion at err/3 each per base,
    never at its two ends. Returns (read, ops, src): the edit ops of the
    read against seg as the bytes M, I, D, and the index in seg of the
    base each op belongs to (an insertion belongs to the base after it)."""
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
    return read, ops, np.repeat(np.arange(len(seg)), n_ops)


def cigar_string(ops):
    """Run-length CIGAR bytes of an op array (bytes M, I, D, S), built
    with array arithmetic: a read's thousands of runs in one pass."""
    cuts = np.flatnonzero(np.r_[True, ops[1:] != ops[:-1], True])
    lens = np.diff(cuts)
    code = ops[cuts[:-1]]
    nd = np.ones(len(lens), np.int64)
    for p in (10, 100, 1000, 10000, 100000, 1000000):
        nd += lens >= p
    width = nd + 1
    end = np.cumsum(width)
    out = np.empty(int(end[-1]), np.uint8)
    out[end - 1] = code
    rest = lens.copy()
    for k in range(int(nd.max())):  # digits, least significant first
        has = nd > k
        out[(end - 2 - k)[has]] = 48 + rest[has] % 10
        rest //= 10
    return out.tobytes()


def make_sam_dataset(workdir, genome_bp, read_len, coverage, err, seed=7):
    """A genome, make_dataset's draft of it (~0.7 % substitutions, ~0.3 %
    deletions) and coverage x genome_bp / read_len reads of the truth at
    `err` (make_cigar_dataset's model: substitutions, insertions and
    deletions at err/3 each; every 3rd read stored reverse-complemented,
    every 4th forward one behind a 7 bp soft clip), each with its overlap
    as a SAM record whose CIGAR is the read's known edits carried onto
    the draft: a truth base the draft lacks turns the read's match into
    an insertion and its deletion into nothing. A read starts and ends on
    truth bases the draft keeps. Writes true.fasta, draft.fasta,
    reads.fasta and ovl.sam into `workdir`; returns the truth."""
    rng = np.random.default_rng(seed)
    true = rng.choice(ACGT, genome_bp)
    draft = true.copy()
    subs = rng.choice(genome_bp, int(genome_bp * 0.007), replace=False)
    draft[subs] = rng.choice(ACGT, len(subs))
    gone = np.zeros(genome_bp, bool)
    gone[rng.choice(genome_bp, int(genome_bp * 0.003), replace=False)] = True
    draft = draft[~gone]
    draft_pos = np.cumsum(~gone) - 1  # draft index of each kept truth base
    kept_at = np.flatnonzero(~gone)
    fasta = []
    sam = [b"@HD\tVN:1.6\n@SQ\tSN:ctg\tLN:%d\n" % len(draft)]
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    for r in range(genome_bp * coverage // read_len):
        s0 = int(rng.integers(0, genome_bp - read_len + 1))
        s = int(kept_at[np.searchsorted(kept_at, s0)])
        e = int(kept_at[np.searchsorted(kept_at, s0 + read_len,
                                        side="right") - 1]) + 1
        read, ops, src = _edited(rng, true[s:e], err)
        lost = gone[s + src]
        ops = ops.copy()
        ops[lost & (ops == ord("M"))] = ord("I")
        ops = ops[~(lost & (ops == ord("D")))]
        rev = r % 3 == 1
        clip = 0 if rev or r % 4 != 2 else 7
        if clip:
            read = np.concatenate([rng.choice(ACGT, clip), read])
            ops = np.concatenate([np.full(clip, ord("S"), np.uint8), ops])
        data = read.tobytes()[::-1].translate(rc) if rev else read.tobytes()
        name = b"read%d" % r
        fasta.append(b">%s\n%s\n" % (name, data))
        sam.append(b"%s\t%d\tctg\t%d\t60\t%s\t*\t0\t0\t*\t*\n"
                   % (name, 16 if rev else 0, int(draft_pos[s]) + 1,
                      cigar_string(ops)))
    for name, parts in (("reads.fasta", fasta), ("ovl.sam", sam)):
        with open(os.path.join(workdir, name), "wb") as f:
            f.write(b"".join(parts))
    for name, seq in (("true.fasta", true), ("draft.fasta", draft)):
        with open(os.path.join(workdir, name), "wb") as f:
            f.write(b">%s\n%s\n" % (b"true" if name[0] == "t" else b"ctg",
                                    seq.tobytes()))
    return true
