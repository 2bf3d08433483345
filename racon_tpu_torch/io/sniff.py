"""File-extension dispatch with reference-exact error messages
(reference: src/polisher.cpp:83-133)."""

from __future__ import annotations

from ..errors import RaconError
from . import fastx, overlaps_io

SEQUENCE_EXTENSIONS = (
    ".fasta", ".fasta.gz", ".fna", ".fna.gz", ".fa", ".fa.gz",
    ".fastq", ".fastq.gz", ".fq", ".fq.gz",
)
OVERLAP_EXTENSIONS = (".mhap", ".mhap.gz", ".paf", ".paf.gz", ".sam", ".sam.gz")

_FASTA_EXT = (".fasta", ".fasta.gz", ".fna", ".fna.gz", ".fa", ".fa.gz")
_FASTQ_EXT = (".fastq", ".fastq.gz", ".fq", ".fq.gz")


def open_sequence_parser(path: str):
    if path.endswith(_FASTA_EXT):
        return fastx.FastaParser(path)
    if path.endswith(_FASTQ_EXT):
        return fastx.FastqParser(path)
    raise RaconError(
        "[racon::createPolisher] error: file %s has unsupported format "
        "extension (valid extensions: .fasta, .fasta.gz, .fna, .fna.gz, .fa, "
        ".fa.gz, .fastq, .fastq.gz, .fq, .fq.gz)!" % path)


def open_overlap_parser(path: str):
    if path.endswith((".mhap", ".mhap.gz")):
        return overlaps_io.MhapParser(path)
    if path.endswith((".paf", ".paf.gz")):
        return overlaps_io.PafParser(path)
    if path.endswith((".sam", ".sam.gz")):
        return overlaps_io.SamParser(path)
    raise RaconError(
        "[racon::createPolisher] error: file %s has unsupported format "
        "extension (valid extensions: .mhap, .mhap.gz, .paf, .paf.gz, .sam, "
        ".sam.gz)!" % path)
