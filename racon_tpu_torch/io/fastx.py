"""FASTA/FASTQ parsing (plain or gzip) into a SequenceStore.

Pure-Python reference implementation; the native C++ parser
(racon_tpu_torch/native/src/fastx.cpp) is used instead when available. Semantics
mirror the reference ingest rules:
  - record name is the header token up to the first whitespace
  - bases are uppercased on ingest           (reference: src/sequence.cpp:24-27)
  - a quality string that is all-'!' (sum of phred values == 0) is dropped
                                             (reference: src/sequence.cpp:34-42)
  - multi-line FASTA and multi-line FASTQ are supported (bioparser equiv)
"""

from __future__ import annotations

import gzip

import numpy as np

from ..errors import RaconError
from ..core.store import SequenceStoreBuilder


def _read_all(path: str) -> bytes:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _name_token(header: bytes) -> bytes:
    # name = header up to first whitespace
    for i, b in enumerate(header):
        if b in (0x20, 0x09):
            return header[:i]
    return header


def parse_fasta(path: str, builder: SequenceStoreBuilder) -> int:
    raw = _read_all(path)
    n = 0
    pos = 0
    size = len(raw)
    while pos < size and raw[pos] in (0x0A, 0x0D):
        pos += 1
    if pos < size and raw[pos] != 0x3E:  # '>'
        raise RaconError(f"[racon_tpu::io] error: malformed FASTA file {path}!")
    while pos < size:
        # at '>'
        eol = raw.find(b"\n", pos)
        if eol == -1:
            eol = size
        header = raw[pos + 1 : eol].rstrip(b"\r")
        # next record starts at a '>' at the beginning of a line
        nxt = raw.find(b"\n>", eol)
        end = size if nxt == -1 else nxt + 1
        data = raw[eol + 1 : end].replace(b"\n", b"").replace(b"\r", b"")
        builder.add(_name_token(header), data.upper(), b"")
        n += 1
        pos = end if nxt == -1 else nxt + 1
    return n


def parse_fastq(path: str, builder: SequenceStoreBuilder) -> int:
    raw = _read_all(path)
    n = 0
    lines = raw.split(b"\n")
    i = 0
    nlines = len(lines)
    while i < nlines:
        line = lines[i].rstrip(b"\r")
        if not line:
            i += 1
            continue
        if line[0] != 0x40:  # '@'
            raise RaconError(f"[racon_tpu::io] error: malformed FASTQ file {path}!")
        header = line[1:]
        i += 1
        data = bytearray()
        while i < nlines:
            line = lines[i].rstrip(b"\r")
            if line.startswith(b"+"):
                break
            data += line
            i += 1
        i += 1  # skip '+'
        qual = bytearray()
        while i < nlines and len(qual) < len(data):
            qual += lines[i].rstrip(b"\r")
            i += 1
        if len(qual) != len(data):
            raise RaconError(f"[racon_tpu::io] error: malformed FASTQ file {path}!")
        # drop all-'!' qualities (phred sum == 0)
        if all(q == 0x21 for q in qual):
            qual = bytearray()
        builder.add(_name_token(header), bytes(data).upper(), bytes(qual))
        n += 1
    return n


def _names_from_blob(blob, off) -> list[bytes]:
    raw = blob.tobytes()
    return [raw[off[i] : off[i + 1]] for i in range(len(off) - 1)]


class _FastxParser:
    def __init__(self, path: str):
        self.path = path

    def parse_into(self, builder: SequenceStoreBuilder) -> int:
        return self._py_parse(self.path, builder)

    def parse_store(self):
        """Parse into a SequenceStore, via the native runtime when available.

        The native path streams the file in chunks (reference: bioparser
        parse(dst, kChunkSize), src/polisher.cpp:229-264): transient memory
        is one chunk of decompressed text plus the accumulated records, not
        2x the whole file. Chunk size: RACON_TPU_CHUNK_BYTES (default 1 GiB).
        """
        import os

        from ..core.store import SequenceStore
        from ..native import loader

        if loader.available():
            from ..native import bindings
            chunk = int(os.environ.get("RACON_TPU_CHUNK_BYTES", 1 << 30))
            all_names: list[bytes] = []
            data_parts, qual_parts = [], []
            doff_parts = [np.zeros(1, np.int64)]
            qoff_parts = [np.zeros(1, np.int64)]
            dshift = qshift = 0
            try:
                for (names, name_off, data, data_off, quals,
                     qual_off) in bindings.fastx_stream(
                         self.path, self.kind == "fastq", chunk):
                    all_names.extend(_names_from_blob(names, name_off))
                    data_parts.append(data)
                    qual_parts.append(quals)
                    doff_parts.append(data_off[1:] + dshift)
                    qoff_parts.append(qual_off[1:] + qshift)
                    dshift += len(data)
                    qshift += len(quals)
            except RuntimeError as e:
                from ..errors import RaconError
                raise RaconError(f"[racon_tpu::io] error: {e}")
            return SequenceStore.from_parts(
                all_names,
                np.concatenate(data_parts) if data_parts else
                np.zeros(0, np.uint8),
                np.concatenate(doff_parts),
                np.concatenate(qual_parts) if qual_parts else
                np.zeros(0, np.uint8),
                np.concatenate(qoff_parts))
        builder = SequenceStoreBuilder()
        self._py_parse(self.path, builder)
        return builder.finish()


class FastaParser(_FastxParser):
    kind = "fasta"
    _py_parse = staticmethod(parse_fasta)


class FastqParser(_FastxParser):
    kind = "fastq"
    _py_parse = staticmethod(parse_fastq)
