"""The plain reference and the frozen generators against the program's
own oracles and generators at small sizes (CPU)."""

import filecmp
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import synth  # noqa: E402
from portbench.reference import align, poa, racon  # noqa: E402
from racon_tpu_torch.core import breakpoints  # noqa: E402
from racon_tpu_torch.io import overlaps_io  # noqa: E402
from racon_tpu_torch.ops import nw_host, poa_host  # noqa: E402
from racon_tpu_torch.testing import synth as port_synth  # noqa: E402


def _rs(rng, n, alpha=b"ACGT"):
    return rng.choice(np.frombuffer(alpha, np.uint8), n).tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_edit_ops_is_the_oracle_path(seed):
    rng = np.random.default_rng(seed)
    for it in range(150):
        m, n = (int(x) for x in rng.integers(0, 70, 2))
        a = _rs(rng, m)
        b = _rs(rng, n, b"AC" if it % 2 else b"ACGT")
        if it % 3 == 0 and m > 5:
            b = bytearray(a)
            for k in rng.choice(m, 5, replace=False):
                b[k] = ord("ACGT"[rng.integers(4)])
            b = bytes(b[: m // 2] + b[m // 2 + 2:])
        s, ops = nw_host.nw_align(np.frombuffer(a, np.uint8),
                                  np.frombuffer(b, np.uint8), 0, -1, -1)
        assert align.edit_distance(a, b) == -s
        assert np.array_equal(np.asarray(ops).reshape(-1, 2),
                              align.edit_ops(a, b))


def test_edit_ops_at_read_length():
    rng = np.random.default_rng(9)
    a = _rs(rng, 1500)
    b = bytearray(a)
    for k in rng.choice(1500, 180, replace=False):
        b[k] = ord("ACGT"[rng.integers(4)])
    b = bytes(b[:700] + b[709:]) + b"ACG"
    s, ops = nw_host.nw_align(np.frombuffer(a, np.uint8),
                              np.frombuffer(b, np.uint8), 0, -1, -1)
    assert np.array_equal(ops, align.edit_ops(a, b))


def test_frozen_make_dataset_writes_the_programs_bytes(tmp_path):
    for ava in (False, True):
        d1, d2 = tmp_path / f"a{ava}", tmp_path / f"b{ava}"
        d1.mkdir()
        d2.mkdir()
        synth.make_dataset(str(d1), 40000, 3000, 8, 0.12, seed=2**31 + 5,
                           ava=ava)
        port_synth.make_dataset(str(d2), 40000, 3000, 8, 0.12,
                                seed=2**31 + 5, ava=ava)
        names = ["reads.fasta", "ovl.paf", "draft.fasta", "true.fasta"]
        names += ["ava.paf", "true_spans.npy"] if ava else []
        for f in names:
            assert filecmp.cmp(d1 / f, d2 / f, shallow=False), f


def test_cigar_string_matches_a_join():
    rng = np.random.default_rng(1)
    for _ in range(100):
        ops = np.frombuffer(bytes(rng.choice(list(b"MMMMIDS"),
                                             rng.integers(1, 3000))),
                            np.uint8)
        cuts = np.flatnonzero(np.r_[True, ops[1:] != ops[:-1], True])
        want = b"".join(b"%d%c" % (b - a, ops[a])
                        for a, b in zip(cuts[:-1], cuts[1:]))
        assert synth.cigar_string(ops) == want
    assert synth.cigar_string(np.full(123456, 77, np.uint8)) == b"123456M"


def test_sam_dataset_cigars_describe_the_reads(tmp_path):
    synth.make_sam_dataset(str(tmp_path), 30000, 2000, 6, 0.12,
                           seed=2**31 + 9)
    draft = racon.read_fasta(str(tmp_path / "draft.fasta"))[0][1]
    reads = dict(racon.read_fasta(str(tmp_path / "reads.fasta")))
    table = overlaps_io.parse_sam(str(tmp_path / "ovl.sam"))
    mine = racon.read_overlaps(str(tmp_path / "ovl.sam"))
    assert len(mine) == len(table) == 90
    rc = bytes.maketrans(b"ACGT", b"TGCA")
    for i, o in enumerate(mine):
        assert (o.q_begin, o.q_end, o.q_length, o.t_begin, o.t_end) == (
            table.q_begin[i], table.q_end[i], table.q_length[i],
            table.t_begin[i], table.t_end[i])
        assert o.q_length == len(reads[o.q])
        # replay the CIGAR: matched bases agree with the draft but for
        # the truth's substitutions in the draft and the read's own
        seq = reads[o.q][::-1].translate(rc) if o.strand else reads[o.q]
        q, t, same, m = 0, o.t_begin, 0, 0
        for op, k in align.cigar_to_ops(o.cigar):
            if op == align.OP_MATCH:
                same += sum(x == y for x, y in zip(seq[q:q + k],
                                                   draft[t:t + k]))
                m += k
                q += k
                t += k
            elif op in (align.OP_INS, align.OP_CLIP):
                q += k
            else:
                t += k
        assert q == o.q_length and t == o.t_end
        assert same / m > 0.9
        bp = racon.align.breaking_points_from_ops(
            align.cigar_to_ops(o.cigar), o.strand, o.q_begin, o.q_end,
            o.q_length, o.t_begin, o.t_end, 500)
        want = breakpoints.breaking_points_from_cigar(
            o.cigar, o.strand, o.q_begin, o.q_end, o.q_length, o.t_begin,
            o.t_end, 500)
        assert np.array_equal(bp, want)


def test_frozen_poa_is_the_programs_oracle():
    rng = np.random.default_rng(4)
    backbone = rng.choice(np.frombuffer(b"ACGT", np.uint8), 300)
    layers = []
    for k in range(8):
        seg = backbone.copy()
        for p in rng.choice(300, 30, replace=False):
            seg[p] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        seg = np.delete(seg, rng.choice(300, 8, replace=False))
        layers.append((seg, None, 0, 299))
    args = (backbone, None, layers, True, True, 3, -5, -4)
    assert poa.consensus_window(*args) == poa_host.consensus_window(*args)
    assert poa.consensus_window(*args, passes=1) == \
        poa_host.consensus_window(*args, passes=1)


def test_reference_in_processes_is_the_serial_reference(tmp_path):
    from portbench import check

    synth.make_dataset(str(tmp_path), 6000, 1500, 8, 0.12, seed=2**31 + 9)
    job = racon.load_job(str(tmp_path / "reads.fasta"),
                         str(tmp_path / "ovl.paf"),
                         str(tmp_path / "draft.fasta"), 500, 0.3, False)
    regions = check.sample_windows(job, 2**31 + 9, 3, 2)
    cfg = {"max_window_depth": 200, "trim": True, "match": 3,
           "mismatch": -5, "gap": -4, "refine_passes": 4,
           "candidate_frac": 0.15, "candidate_min": 2}
    serial = check.reference_answers(job, regions, cfg, 1)
    assert check.reference_answers(job, regions, cfg, 3) == serial
    shallow = check.window_answers(job, serial, dict(cfg, refine_passes=1),
                                   2)
    assert shallow.keys() == serial.keys()
    assert shallow == check.window_answers(
        job, serial, dict(cfg, refine_passes=1), 1)
