"""Sequence sampler of the port, the rampler equivalent: a copy of
racon_tpu/tools/rampler.py over the port's parsers.

The reference ships rampler as a standalone vendored binary whose only two
consumers are the wrapper's --subsample and --split features
(scripts/racon_wrapper.py:62-111). Semantics reproduced here:

  subsample <sequences> <reference length> <coverage> [...]
      for each coverage c, emit <out>/<base>_<c>x.<ext> holding a random
      subset of the input with expected total length ref_len * c
      (each sequence kept i.i.d. with p = ref_len * c / total_bases).
  split <sequences> <chunk size>
      emit <out>/<base>_<i>.<ext> chunks whose sequence bytes do not exceed
      chunk_size (oversized single records get their own chunk).

<base> is the input basename up to the first '.'; <ext> is .fasta or .fastq
matching the input family (the wrapper reconstructs these names,
scripts/racon_wrapper.py:71-78,96-110). Output is uncompressed.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..errors import RaconError
from ..io.sniff import open_sequence_parser, _FASTA_EXT


def _load(path: str):
    """Returns (store, is_fasta). Store fields: names/data/quality per index."""
    parser = open_sequence_parser(path)
    return parser.parse_store(), parser.kind == "fasta"


def _base_and_ext(path: str):
    base = os.path.basename(path).split(".")[0]
    ext = ".fasta" if path.endswith(_FASTA_EXT) else ".fastq"
    return base, ext


def _write_records(f, store, indices, fasta: bool) -> None:
    for i in indices:
        i = int(i)
        name = store.names[i]
        data = store.data(i).tobytes()
        qual = store.quality(i).tobytes()
        if fasta or not qual:
            f.write(b">" + name + b"\n" + data + b"\n")
        else:
            f.write(b"@" + name + b"\n" + data + b"\n+\n" + qual + b"\n")


def subsample(path: str, reference_length: int, coverages, out_dir: str = ".",
              seed: int | None = None) -> list[str]:
    store, fasta = _load(path)
    total = int(store.lengths().sum())
    if total == 0:
        raise RaconError("[rampler::] error: empty sequences file!")
    base, ext = _base_and_ext(path)
    rng = np.random.default_rng(seed)
    out_paths = []
    for cov in coverages:
        p = min(1.0, float(reference_length) * float(cov) / total)
        keep = np.flatnonzero(rng.random(len(store)) < p)
        out_path = os.path.join(out_dir, f"{base}_{cov}x{ext}")
        with open(out_path, "wb") as f:
            _write_records(f, store, keep, fasta)
        out_paths.append(out_path)
    return out_paths


def split(path: str, chunk_size: int, out_dir: str = ".") -> list[str]:
    store, fasta = _load(path)
    if chunk_size <= 0:
        raise RaconError("[rampler::] error: invalid chunk size!")
    base, ext = _base_and_ext(path)
    lengths = store.lengths()
    out_paths = []
    chunk: list[int] = []
    used = 0

    def flush():
        nonlocal chunk, used
        if not chunk:
            return
        out_path = os.path.join(out_dir, f"{base}_{len(out_paths)}{ext}")
        with open(out_path, "wb") as f:
            _write_records(f, store, chunk, fasta)
        out_paths.append(out_path)
        chunk, used = [], 0

    for i in range(len(store)):
        if chunk and used + int(lengths[i]) > chunk_size:
            flush()
        chunk.append(i)
        used += int(lengths[i])
    flush()
    return out_paths


HELP = """usage: rampler [options ...] <mode>

    <mode>
        subsample <sequences> <reference length> <coverage> [<coverage> ...]
            <sequences>
                input file in FASTA/FASTQ format (can be compressed with gzip)
            <reference length>
                integral number of the reference length
            <coverage>
                integral number of the desired coverage
        split <sequences> <chunk size>
            <sequences>
                input file in FASTA/FASTQ format (can be compressed with gzip)
            <chunk size>
                size of chunks in bytes

    options:
        -o, --out-directory <string>
            default: current directory
            path in which sampled files will be created
        --seed <int>
            seed for the subsample random generator
        --version
            prints the version number
        -h, --help
            prints the usage
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    out_dir = "."
    seed = None
    pos: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-o", "--out-directory"):
            i += 1
            out_dir = argv[i]
        elif a == "--seed":
            i += 1
            seed = int(argv[i])
        elif a in ("-h", "--help"):
            print(HELP, end="")
            return 0
        elif a == "--version":
            from .. import __version__
            print(f"v{__version__}")
            return 0
        else:
            pos.append(a)
        i += 1

    try:
        if len(pos) >= 4 and pos[0] == "subsample":
            subsample(pos[1], int(pos[2]), pos[3:], out_dir, seed)
        elif len(pos) == 3 and pos[0] == "split":
            split(pos[1], int(pos[2]), out_dir)
        else:
            sys.stderr.write("[rampler::] error: invalid mode!\n")
            print(HELP, end="")
            return 1
    except RaconError as e:
        sys.stderr.write(e.message + "\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
