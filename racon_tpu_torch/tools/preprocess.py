"""Illumina paired-end preprocessor of the port: a copy of
racon_tpu/tools/preprocess.py (reference: scripts/racon_preprocess.py).

Paired-end FASTQ reads usually share a header up to the first whitespace;
racon keys sequences by that token, so pairs would collide. This tool makes
each header unique: the first occurrence of a name gets suffix '1', any later
occurrence gets '2' (reference :25-29). One or two input files share one seen
set (:76-79); output is interleaved-as-read FASTQ on stdout. Multi-line
sequence/quality records are joined (:37-46). Gzip input is accepted (an
extension over the reference, which the rest of this framework supports
everywhere).
"""

from __future__ import annotations

import gzip
import sys


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def parse_file(path: str, seen: set, out) -> None:
    def emit(name, data, qual):
        if len(name) == 0 or len(data) == 0 or len(data) != len(qual):
            sys.stderr.write("File is not in FASTQ format\n")
            sys.exit(1)
        suffix = "2" if name in seen else "1"
        if suffix == "1":
            seen.add(name)
        out.write(name + suffix + "\n" + data + "\n+\n" + qual + "\n")

    state = 0  # 0: expect header, 1: sequence lines, 2: quality lines
    name = data = qual = ""
    pending = False
    with _open(path) as f:
        for line in f:
            if state == 0:
                if pending:
                    emit(name, data, qual)
                    pending = False
                name = line.rstrip().split(" ")[0]
                data = qual = ""
                state = 1
            elif state == 1:
                if line[0] == "+":
                    state = 2
                else:
                    data += line.rstrip()
            else:
                qual += line.rstrip()
                if len(qual) >= len(data):
                    pending = True
                    state = 0
    if pending:
        emit(name, data, qual)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or len(argv) > 2:
        sys.stderr.write(
            "usage: racon_preprocess <first> [<second>]\n\n"
            "    Makes Illumina paired-end FASTQ headers unique (suffix 1/2\n"
            "    by first occurrence) so pairs do not collide in racon.\n")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    seen: set = set()
    parse_file(argv[0], seen, sys.stdout)
    if len(argv) == 2:
        parse_file(argv[1], seen, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
