"""racon's other modes on the port, against racon_tpu, on the CPU.

For each case the port's cuda backend on device="cpu" (the kernels'
plain versions) must give racon_tpu's FASTA byte for byte, racon_tpu
running `--backend tpu` with its kernels interpreted at the real tier
shapes (RACON_TPU_INTERPRET_FULLCAP=1, RACON_TPU_CONSENSUS_ROUTE=device),
as tests/test_torch_e2e.py's test_fasta_matches_racon_tpu does:

- kF, fragment correction on all-vs-all PAF: tests/test_pipeline_small.py's
  dual-overlap case (:106) and a testing.synth.make_dataset(ava=True) one;
  every record's name carries kF's "r";
- kNGS (mean read length <= 1000, :144): the NGS window type on both, and
  no trimming of the uncovered ends;
- FASTQ reads whose qualities make -q 10 drop layers: the same count of
  layers kept on both, fewer than at -q 0;
- MHAP overlaps (no CIGAR): every overlap through the device align stage;
- SAM overlaps with CIGARs written from the generator's known edits
  (reverse-strand and soft-clipped reads among them): breaking points from
  the CIGARs, and the align stage receives no item;
- gzip inputs and -u (drop_unpolished_sequences=False, :62): an orphan
  target passes through unpolished.

Then one parser-level test: on one synthetic set of FASTA, FASTQ, PAF,
MHAP and SAM files, plain and gzipped, the port's io/ and core/ give
racon_tpu's records, qualities, transmuted and filtered overlaps and
CIGAR breaking points, through the native parsers and the Python ones.
"""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from racon_tpu import io as jax_io
from racon_tpu.core import breakpoints as jax_breakpoints
from racon_tpu.core import overlaps as jax_overlaps
from racon_tpu.core import store as jax_store
from racon_tpu.core.windows import WINDOW_TYPE_NGS as JAX_NGS
from racon_tpu.io import overlaps_io as jax_overlaps_io
from racon_tpu.models.polish_model import PolisherConfig as JaxPolisherConfig
from racon_tpu.models.polish_model import PolisherType as JaxPolisherType
from racon_tpu.polisher import create_polisher as jax_create_polisher
from racon_tpu_torch import io as port_io
from racon_tpu_torch.core import breakpoints as port_breakpoints
from racon_tpu_torch.core import overlaps as port_overlaps
from racon_tpu_torch.core import store as port_store
from racon_tpu_torch.core.windows import WINDOW_TYPE_NGS
from racon_tpu_torch.io import overlaps_io as port_overlaps_io
from racon_tpu_torch.models.polish_model import PolisherConfig, PolisherType
from racon_tpu_torch.native import bindings
from racon_tpu_torch.polisher import create_polisher
from racon_tpu_torch.testing.synth import make_cigar_dataset, make_dataset

torch.set_num_threads(2)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _contig_case(d):
    """testing.synth.make_cigar_dataset at 1.5 kb: 15 reads of 1.2 kb at
    3 % error, every 3rd reverse-complemented, every 4th forward one
    soft-clipped, every 5th with a low-quality first half in FASTQ."""
    return make_cigar_dataset(str(d), 1500, 1200, 12, 0.03)


# ---------------------------------------------------------------- the cases
# each: tmp_path -> (input paths, PolisherConfig fields ("type" as "kC" or
# "kF"), drop_unpolished_sequences, check(port FASTA, port Polisher,
# racon_tpu Polisher, tmp_path))


def _kf_dual(d):
    """tests/test_pipeline_small.py:106: six 600 bp reads with six
    substitutions each, every ordered pair an overlap."""
    rng = np.random.default_rng(3)
    true = rng.choice(ACGT, 600)
    reads = []
    for r in range(6):
        read = true.copy()
        for pos in rng.choice(600, 6, replace=False):
            read[pos] = rng.choice(ACGT)
        reads.append(b">r%d\n%s\n" % (r, read.tobytes()))
    (d / "reads.fasta").write_bytes(b"".join(reads))
    (d / "ava.paf").write_bytes(b"".join(
        b"r%d\t600\t0\t600\t+\tr%d\t600\t0\t600\t550\t600\t60\n" % (a, b)
        for a in range(6) for b in range(6) if a != b))
    paths = [str(d / f) for f in ("reads.fasta", "ava.paf", "reads.fasta")]

    def check(got, p, q, d):
        assert len(got) == 6
        for (name, data), raw in zip(got, reads):
            assert name.split(b" ")[0] == raw.split(b"\n")[0][1:] + b"r"
            assert (bindings.edit_distance(data, true.tobytes())
                    <= bindings.edit_distance(raw.split(b"\n")[1],
                                              true.tobytes()))
    return paths, dict(type="kF", window_length=300), True, check


def _kf_ava(d):
    """make_dataset(ava=True): 6 kb of genome, 8x 2 kb reads at 6 %
    error, all-vs-all overlaps from the known sampling intervals."""
    make_dataset(str(d), 6000, 2000, 8, 0.06, seed=3, ava=True)
    paths = [str(d / f) for f in ("reads.fasta", "ava.paf", "reads.fasta")]

    def check(got, p, q, d):
        assert len(got) > 10
        assert all(name.split(b" ")[0].endswith(b"r") for name, _ in got)
        st = p.align_stage.stats
        assert st["device_items"] == st["items"] > 20
        assert st["host_items"] == 0
    return paths, dict(type="kF"), True, check


def _ngs(d):
    """tests/test_pipeline_small.py:144: ten 300 bp reads over the middle
    of a 700 bp contig; -w 700."""
    rng = np.random.default_rng(3)
    true = rng.choice(ACGT, 700)
    draft = true.copy()
    for pos in rng.choice(700, 8, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for r in range(10):
        s = 150 + int(rng.integers(0, 100))
        e = min(s + 300, 640)
        read = true[s:e].copy()
        for pos in rng.choice(len(read), 3, replace=False):
            read[pos] = rng.choice(ACGT)
        reads.append(b">sr%d\n%s\n" % (r, read.tobytes()))
        paf.append(b"sr%d\t%d\t0\t%d\t+\tctg\t700\t%d\t%d\t50\t50\t60\n"
                   % (r, len(read), len(read), s, e))
    (d / "r.fasta").write_bytes(b"".join(reads))
    (d / "o.paf").write_bytes(b"".join(paf))
    (d / "d.fasta").write_bytes(b">ctg\n" + draft.tobytes() + b"\n")
    paths = [str(d / f) for f in ("r.fasta", "o.paf", "d.fasta")]

    def check(got, p, q, d):
        assert p.windows.window_type == WINDOW_TYPE_NGS
        assert q.windows.window_type == JAX_NGS
        assert len(got) == 1 and len(got[0][1]) >= 650  # untrimmed
    return paths, dict(window_length=700), False, check


def _fastq_q(d):
    _contig_case(d)
    paths = [str(d / f) for f in ("reads.fastq", "ovl.paf", "draft.fasta")]

    def check(got, p, q, d):
        kept = len(p.windows.lay_win)
        assert kept == len(q.windows.lay_win)
        with contextlib.redirect_stderr(io.StringIO()):
            p0 = create_polisher(*paths, PolisherConfig(
                backend="cuda", num_threads=2, quality_threshold=0.0),
                device="cpu")
            p0.initialize()
        assert kept < len(p0.windows.lay_win)
    return paths, {}, True, check


def _mhap(d):
    _contig_case(d)
    paths = [str(d / f) for f in ("reads.fasta", "ovl.mhap", "draft.fasta")]

    def check(got, p, q, d):
        st = p.align_stage.stats
        assert st["device_items"] == st["items"] == 15
        assert st["host_items"] == 0
    return paths, {}, True, check


def _sam(d):
    _contig_case(d)
    paths = [str(d / f) for f in ("reads.fasta", "ovl.sam", "draft.fasta")]

    def check(got, p, q, d):
        assert p.align_stage.stats["items"] == 0
        assert not p.align_stage.stats["tier_items"]
    return paths, {}, True, check


def _gz_unpolished(d):
    """tests/test_pipeline_small.py:62: gzipped inputs, and a second
    target with no overlaps, kept by -u."""
    rng = np.random.default_rng(7)
    true = rng.choice(ACGT, 800)
    draft = true.copy()
    for pos in rng.choice(800, 10, replace=False):
        draft[pos] = rng.choice(ACGT)
    reads, paf = [], []
    for r in range(12):
        s, e = int(rng.integers(0, 200)), int(rng.integers(600, 800))
        read = true[s:e].copy()
        for pos in rng.choice(len(read), max(1, len(read) // 50),
                              replace=False):
            read[pos] = rng.choice(ACGT)
        reads.append(b">read%d\n%s\n" % (r, read.tobytes()))
        paf.append(b"read%d\t%d\t0\t%d\t+\tcontig1\t800\t%d\t%d\t100\t100"
                   b"\t60\n" % (r, len(read), len(read), s, e))
    (d / "reads.fasta.gz").write_bytes(gzip.compress(b"".join(reads)))
    (d / "ovl.paf.gz").write_bytes(gzip.compress(b"".join(paf)))
    (d / "draft2.fasta.gz").write_bytes(gzip.compress(
        b">contig1\n" + draft.tobytes() + b"\n>orphan\n" + b"ACGT" * 50
        + b"\n"))
    paths = [str(d / f) for f in ("reads.fasta.gz", "ovl.paf.gz",
                                  "draft2.fasta.gz")]

    def check(got, p, q, d):
        assert len(got) == 2
        assert got[0][0].startswith(b"contig1 LN:i:")
        assert got[1][0].startswith(b"orphan LN:i:200 ")
        assert got[1][1] == b"ACGT" * 50
    return paths, dict(window_length=200), False, check


CASES = {"kF_dual": _kf_dual, "kF_ava": _kf_ava, "kNGS": _ngs,
         "fastq_q10": _fastq_q, "mhap": _mhap, "sam_cigar": _sam,
         "gz_unpolished": _gz_unpolished}


def _polish(create, config, ptype, paths, fields, drop, **kw):
    fields = dict(fields)
    fields["type"] = getattr(ptype, fields.get("type", "kC"))
    with contextlib.redirect_stderr(io.StringIO()):
        p = create(*paths, config(num_threads=2, **fields), **kw)
        p.initialize()
        return p.polish(drop), p


@pytest.mark.parametrize("case", list(CASES))
def test_mode_matches_racon_tpu(tmp_path, monkeypatch, case):
    paths, fields, drop, check = CASES[case](tmp_path)
    got, p = _polish(create_polisher,
                     lambda **f: PolisherConfig(backend="cuda", **f),
                     PolisherType, paths, fields, drop, device="cpu")
    # the reference's interpreted stages, at the real tier shapes
    monkeypatch.setenv("RACON_TPU_INTERPRET_FULLCAP", "1")
    monkeypatch.setenv("RACON_TPU_CONSENSUS_ROUTE", "device")
    want, q = _polish(jax_create_polisher,
                      lambda **f: JaxPolisherConfig(backend="tpu", **f),
                      JaxPolisherType, paths, fields, drop)
    assert got == want
    assert got and all(data for _, data in got)
    check(got, p, q, tmp_path)


# ------------------------------------------------------- the parsers' copies

PKGS = {"port": (port_io, port_overlaps_io, port_overlaps, port_store,
                 port_breakpoints),
        "racon_tpu": (jax_io, jax_overlaps_io, jax_overlaps, jax_store,
                      jax_breakpoints)}


def _store(s):
    return [list(s.names), s.blob, s.data_off, s.qual_blob, s.qual_off]


def _ingest(pkg, reads, ovl, targets, kf, native):
    """What one package's io/ and core/ make of the inputs, as the
    Polisher's initialize() uses them up to the align stage: the target
    and read records, the merged store, the overlaps after transmute and
    filtering, and the breaking points of those that carry a CIGAR."""
    io_, ovl_io, ovl_core, store, bp = PKGS[pkg]
    tstore = io_.open_sequence_parser(targets).parse_store()
    rparser = io_.open_sequence_parser(reads)
    rstore = (rparser.parse_store() if native else
              _py_store(rparser, store))
    name_to_id, id_to_id = {}, {}
    for i in range(len(tstore)):
        name_to_id[tstore.names[i] + b"t"] = i
        id_to_id[i << 1 | 1] = i
    keep = np.ones(len(rstore), bool)
    for i in range(len(rstore)):
        tid = name_to_id.get(rstore.names[i] + b"t")
        if tid is not None:
            keep[i] = False
    before = np.cumsum(keep) - keep
    for i in range(len(rstore)):
        tid = name_to_id.get(rstore.names[i] + b"t")
        internal = tid if tid is not None else len(tstore) + int(before[i])
        name_to_id[rstore.names[i] + b"q"] = internal
        id_to_id[i << 1 | 0] = internal
    merged = store.merge_stores(tstore, rstore, keep)
    oparser = io_.open_overlap_parser(ovl)
    table = (ovl_core.OverlapTable.concat(list(oparser.parse_chunks(1 << 20)))
             if native else oparser._py_parse(ovl))
    table.transmute(merged, name_to_id, id_to_id)
    table.compact(table.filter_invalid(0.3, keep_longest_per_query=not kf))
    cols = [table.q_names, table.t_names, table.cigars, table.strand,
            table.is_valid, table.error]
    cols += [getattr(table, k) for k in (
        "q_id", "q_begin", "q_end", "q_length", "t_id", "t_begin", "t_end",
        "t_length", "length")]
    points = [bp.breaking_points_from_cigar(
        table.cigars[i], bool(table.strand[i]), int(table.q_begin[i]),
        int(table.q_end[i]), int(table.q_length[i]), int(table.t_begin[i]),
        int(table.t_end[i]), 300) for i in range(len(table))
        if table.cigars[i]]
    return [_store(tstore), _store(rstore), _store(merged), cols, points]


def _py_store(parser, store):
    records = store.SequenceStoreBuilder()
    parser.parse_into(records)
    return records.finish()


def _equal(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, bytes):
        assert a == b
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_parsers_match_racon_tpu(tmp_path, gz):
    _contig_case(tmp_path)
    names = ["reads.fasta", "reads.fastq", "ovl.paf", "ovl.mhap", "ovl.sam",
             "draft.fasta"]
    if gz:
        for f in names:
            raw = (tmp_path / f).read_bytes()
            (tmp_path / (f + ".gz")).write_bytes(gzip.compress(raw))
        names = [f + ".gz" for f in names]
    p = {f.split(".")[0] + "." + f.split(".")[1]: str(tmp_path / f)
         for f in names}
    seen = 0
    for reads in ("reads.fasta", "reads.fastq"):
        for ovl in ("ovl.paf", "ovl.mhap", "ovl.sam"):
            for kf in (False, True):
                for native in (True, False):
                    args = (p[reads], p[ovl], p["draft.fasta"], kf, native)
                    got = _ingest("port", *args)
                    want = _ingest("racon_tpu", *args)
                    _equal(got, want)
                    assert len(got[3][0]) == 15  # every overlap kept
                    seen += len(got[4])
    # the SAM runs walked every record's CIGAR, the others none
    assert seen == 2 * 2 * 2 * 15
