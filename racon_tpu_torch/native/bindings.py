"""ctypes bindings to libracon_host.so (see src/capi.cpp)."""

from __future__ import annotations

import ctypes as C

import numpy as np

from . import loader

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _configure(lib: C.CDLL) -> C.CDLL:
    lib.rt_last_error.restype = C.c_char_p
    lib.rt_parse_fastx.restype = C.c_void_p
    lib.rt_parse_fastx.argtypes = [C.c_char_p, C.c_int32, C.POINTER(C.c_int64),
                                   C.POINTER(C.c_int64), C.POINTER(C.c_int64),
                                   C.POINTER(C.c_int64)]
    lib.rt_fastx_export.argtypes = [C.c_void_p, _u8p, _i64p, _u8p, _i64p,
                                    _u8p, _i64p]
    lib.rt_fastx_free.argtypes = [C.c_void_p]
    lib.rt_fastx_stream_open.restype = C.c_void_p
    lib.rt_fastx_stream_open.argtypes = [C.c_char_p, C.c_int32]
    lib.rt_fastx_stream_next.restype = C.c_void_p
    lib.rt_fastx_stream_next.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_int64),
        C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_int32)]
    lib.rt_fastx_stream_free.argtypes = [C.c_void_p]
    lib.rt_parse_overlaps.restype = C.c_void_p
    lib.rt_parse_overlaps.argtypes = [C.c_char_p, C.c_int32,
                                      C.POINTER(C.c_int64),
                                      C.POINTER(C.c_int64),
                                      C.POINTER(C.c_int64),
                                      C.POINTER(C.c_int64)]
    lib.rt_overlaps_export.argtypes = [C.c_void_p, _u8p, _i64p, _u8p, _i64p,
                                       _u8p, _i64p] + [_i64p] * 9 + \
        [_u8p, _u8p, _f64p]
    lib.rt_overlaps_free.argtypes = [C.c_void_p]
    lib.rt_overlap_stream_open.restype = C.c_void_p
    lib.rt_overlap_stream_open.argtypes = [C.c_char_p, C.c_int32]
    lib.rt_overlap_stream_next.restype = C.c_void_p
    lib.rt_overlap_stream_next.argtypes = [
        C.c_void_p, C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_int64),
        C.POINTER(C.c_int64), C.POINTER(C.c_int64), C.POINTER(C.c_int32)]
    lib.rt_overlap_stream_free.argtypes = [C.c_void_p]
    lib.rt_edit_distance.restype = C.c_int64
    lib.rt_edit_distance.argtypes = [_u8p, C.c_int64, _u8p, C.c_int64]
    lib.rt_breaking_points_batch.argtypes = [
        _u8p, _i64p, _u8p, _i64p, _u8p, _i64p, _i64p, _i64p, _i64p, _i64p,
        C.c_int64, C.c_int32, C.c_int32, _i64p, _i64p, _i64p]
    lib.rt_align_batch.argtypes = [
        _u8p, _i64p, _u8p, _i64p, C.c_int64, C.c_int32, C.c_int32, C.c_int32,
        C.c_int32, C.c_int32, _i32p, _i64p, _i64p]
    lib.rt_align_batch_percol.argtypes = [
        _u8p, _i64p, _u8p, _i64p, C.c_void_p, C.c_int64, C.c_int32, C.c_int32,
        C.c_int32, C.c_int32, C.c_int32, _i32p, _i64p, _i64p]
    lib.rt_walk_moves_batch.argtypes = [
        _i32p, _i64p, _i64p, C.c_int64, C.c_int64, C.c_int64, C.c_int64,
        C.c_int32, _i32p, _i64p, _i64p]
    lib.rt_breaking_points_from_ops_batch.argtypes = [
        _i32p, _i64p, _i64p, _u8p, _i64p, _i64p, _i64p, _i64p, _i64p,
        C.c_int64, C.c_int32, C.c_int32, _i64p, _i64p, _i64p]
    lib.rt_opstream_to_ops_batch.argtypes = [
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"), C.c_int64,
        C.c_int64, C.c_int32, _i32p, _i64p, _i64p]
    lib.rt_opstream_packed_to_ops_batch.argtypes = [
        _u8p, C.c_int64, C.c_int64, C.c_int32, _i32p, _i64p, C.c_void_p,
        _i64p]
    lib.rt_opstream_rle_to_ops_batch.argtypes = [
        _u8p, C.c_int64, C.c_int64, C.c_int32, _i32p, _i64p, C.c_void_p,
        _i64p]
    lib.rt_opstream_rows_to_ops_batch.argtypes = [
        _u8p, C.c_int64, C.c_int64, C.c_int32, _i32p, _i64p, C.c_void_p,
        _i64p]
    lib.rt_pack_rows.argtypes = [
        _u8p, _i64p, _i64p, C.c_int64, C.c_int64, C.c_uint8, _u8p, C.c_int32]
    lib.rt_pack_rows_nib.argtypes = [
        _u8p, _i64p, _i64p, C.c_int64, C.c_int64, C.c_uint8, _u8p, C.c_int32]
    lib.rt_pack_rows_bits.argtypes = [
        _u8p, _i64p, _i64p, C.c_int64, C.c_int64, _u8p, C.c_int32]
    lib.rt_gather_ranges.argtypes = [
        _u8p, C.c_int64, _i64p, _i64p, _i64p, C.c_int64, _u8p, C.c_int32]
    lib.rt_compose_slots.argtypes = [
        _i64p, _i64p, _i64p, _i32p, _i64p, _i64p, _i64p, C.c_int64, _i64p,
        C.c_int32]
    lib.rt_project_spans.argtypes = [
        _i64p, _i64p, _i64p, _i64p, _i64p, C.c_int64, _i64p, _i64p,
        C.c_int32]
    lib.rt_poa_round_batch.argtypes = [
        C.c_int64, _u8p, _i64p, _i32p, _i64p, _u8p, _i64p, _i32p, _i32p,
        _i32p, _i64p, C.c_void_p, C.c_int32, C.c_int32, C.c_int32, C.c_int32,
        C.c_double, C.c_int32, C.c_int64, _i64p, _i32p, C.c_int32, _u8p,
        _i64p, _i64p, _i32p, _i32p, _u8p, C.c_void_p, C.c_void_p, C.c_void_p,
        C.c_void_p]
    lib.rt_consensus_batch.argtypes = [
        C.c_int64, _u8p, _i64p, _i32p, _i64p, _i32p, _i64p, _u8p, _i64p,
        _i32p, _i32p, _i32p, C.c_void_p, C.c_void_p, C.c_int32, C.c_int32,
        C.c_int32, C.c_int32, C.c_int32, C.c_int32, C.c_double, C.c_int32,
        C.c_int32, _u8p, _i64p, _i64p, _u8p]
    return lib


_cached = None


def get_lib() -> C.CDLL | None:
    global _cached
    if _cached is None:
        lib = loader.get()
        if lib is None:
            return None
        _cached = _configure(lib)
    return _cached


def _as_u8(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.uint8)


def edit_distance(a, b) -> int:
    lib = get_lib()
    a = _as_u8(np.frombuffer(a, np.uint8) if isinstance(a, (bytes, bytearray)) else a)
    b = _as_u8(np.frombuffer(b, np.uint8) if isinstance(b, (bytes, bytearray)) else b)
    return int(lib.rt_edit_distance(a, len(a), b, len(b)))


def parse_fastx(path: str, is_fastq: bool):
    """Returns (names_blob, name_off, data_blob, data_off, qual_blob, qual_off)."""
    lib = get_lib()
    n = C.c_int64()
    nb = C.c_int64()
    db = C.c_int64()
    qb = C.c_int64()
    h = lib.rt_parse_fastx(path.encode(), 1 if is_fastq else 0, C.byref(n),
                           C.byref(nb), C.byref(db), C.byref(qb))
    if not h:
        raise RuntimeError(lib.rt_last_error().decode())
    try:
        names = np.empty(nb.value, np.uint8)
        data = np.empty(db.value, np.uint8)
        quals = np.empty(qb.value, np.uint8)
        name_off = np.empty(n.value + 1, np.int64)
        data_off = np.empty(n.value + 1, np.int64)
        qual_off = np.empty(n.value + 1, np.int64)
        lib.rt_fastx_export(h, names, name_off, data, data_off, quals, qual_off)
    finally:
        lib.rt_fastx_free(h)
    return names, name_off, data, data_off, quals, qual_off


def _export_overlaps(lib, h, nv: int, qn: int, tn: int, cg: int) -> dict:
    try:
        out = {
            "qname_blob": np.empty(qn, np.uint8),
            "qname_off": np.empty(nv + 1, np.int64),
            "tname_blob": np.empty(tn, np.uint8),
            "tname_off": np.empty(nv + 1, np.int64),
            "cigar_blob": np.empty(cg, np.uint8),
            "cigar_off": np.empty(nv + 1, np.int64),
            "q_id": np.empty(nv, np.int64),
            "t_id": np.empty(nv, np.int64),
            "q_begin": np.empty(nv, np.int64),
            "q_end": np.empty(nv, np.int64),
            "q_length": np.empty(nv, np.int64),
            "t_begin": np.empty(nv, np.int64),
            "t_end": np.empty(nv, np.int64),
            "t_length": np.empty(nv, np.int64),
            "length": np.empty(nv, np.int64),
            "strand": np.empty(nv, np.uint8),
            "is_valid": np.empty(nv, np.uint8),
            "error": np.empty(nv, np.float64),
        }
        lib.rt_overlaps_export(
            h, out["qname_blob"], out["qname_off"], out["tname_blob"],
            out["tname_off"], out["cigar_blob"], out["cigar_off"], out["q_id"],
            out["t_id"], out["q_begin"], out["q_end"], out["q_length"],
            out["t_begin"], out["t_end"], out["t_length"], out["length"],
            out["strand"], out["is_valid"], out["error"])
    finally:
        lib.rt_overlaps_free(h)
    return out


def fastx_stream(path: str, is_fastq: bool, max_bytes: int):
    """Chunked streaming parse of FASTA/FASTQ: yields parse_fastx-style
    tuples covering ~max_bytes of decompressed text each."""
    lib = get_lib()
    sh = lib.rt_fastx_stream_open(path.encode(), 1 if is_fastq else 0)
    if not sh:
        raise RuntimeError(lib.rt_last_error().decode())
    try:
        while True:
            n = C.c_int64()
            nb = C.c_int64()
            db = C.c_int64()
            qb = C.c_int64()
            eof = C.c_int32()
            h = lib.rt_fastx_stream_next(sh, max_bytes, C.byref(n),
                                         C.byref(nb), C.byref(db),
                                         C.byref(qb), C.byref(eof))
            if not h:
                raise RuntimeError(lib.rt_last_error().decode())
            try:
                names = np.empty(nb.value, np.uint8)
                data = np.empty(db.value, np.uint8)
                quals = np.empty(qb.value, np.uint8)
                name_off = np.empty(n.value + 1, np.int64)
                data_off = np.empty(n.value + 1, np.int64)
                qual_off = np.empty(n.value + 1, np.int64)
                lib.rt_fastx_export(h, names, name_off, data, data_off,
                                    quals, qual_off)
            finally:
                lib.rt_fastx_free(h)
            yield names, name_off, data, data_off, quals, qual_off
            if eof.value:
                break
    finally:
        lib.rt_fastx_stream_free(sh)


def parse_overlaps(path: str, fmt: int):
    lib = get_lib()
    n = C.c_int64()
    qn = C.c_int64()
    tn = C.c_int64()
    cg = C.c_int64()
    h = lib.rt_parse_overlaps(path.encode(), fmt, C.byref(n), C.byref(qn),
                              C.byref(tn), C.byref(cg))
    if not h:
        raise RuntimeError(lib.rt_last_error().decode())
    return _export_overlaps(lib, h, n.value, qn.value, tn.value, cg.value)


def overlap_stream(path: str, fmt: int, max_bytes: int):
    """Chunked streaming parse: yields parse_overlaps-style dicts covering
    ~max_bytes of decompressed text each (bioparser parse(dst, max_bytes)
    role, reference kChunkSize = 1 GiB)."""
    lib = get_lib()
    sh = lib.rt_overlap_stream_open(path.encode(), fmt)
    if not sh:
        raise RuntimeError(lib.rt_last_error().decode())
    try:
        while True:
            n = C.c_int64()
            qn = C.c_int64()
            tn = C.c_int64()
            cg = C.c_int64()
            eof = C.c_int32()
            h = lib.rt_overlap_stream_next(sh, max_bytes, C.byref(n),
                                           C.byref(qn), C.byref(tn),
                                           C.byref(cg), C.byref(eof))
            if not h:
                raise RuntimeError(lib.rt_last_error().decode())
            yield _export_overlaps(lib, h, n.value, qn.value, tn.value,
                                   cg.value)
            if eof.value:
                break
    finally:
        lib.rt_overlap_stream_free(sh)


def breaking_points_batch(qblob, qoff, tblob, toff, strand, q_begin, q_end,
                          q_length, t_begin, t_end, window_length: int,
                          n_threads: int):
    """Returns (quads flat int64 (sum_max,4), offsets, counts)."""
    lib = get_lib()
    n = len(strand)
    max_quads = (t_end - t_begin) // window_length + 2
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(max_quads, out=out_off[1:])
    out = np.zeros(int(out_off[-1]) * 4, np.int64)
    counts = np.zeros(n, np.int64)
    lib.rt_breaking_points_batch(
        _as_u8(qblob), np.ascontiguousarray(qoff, np.int64), _as_u8(tblob),
        np.ascontiguousarray(toff, np.int64), _as_u8(strand),
        np.ascontiguousarray(q_begin, np.int64),
        np.ascontiguousarray(q_end, np.int64),
        np.ascontiguousarray(q_length, np.int64),
        np.ascontiguousarray(t_begin, np.int64),
        np.ascontiguousarray(t_end, np.int64), n, window_length, n_threads,
        out, out_off, counts)
    return out.reshape(-1, 4), out_off, counts


def align_batch(qblob, qoff, tblob, toff, match, mismatch, gap, edit_mode,
                n_threads):
    """Returns (ops flat int32 (sum,2), offsets, counts)."""
    lib = get_lib()
    n = len(qoff) - 1
    qlen = np.diff(np.asarray(qoff))
    tlen = np.diff(np.asarray(toff))
    max_ops = qlen + tlen + 2  # run-length ops can never exceed path length
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(max_ops, out=out_off[1:])
    out = np.zeros(int(out_off[-1]) * 2, np.int32)
    counts = np.zeros(n, np.int64)
    lib.rt_align_batch(_as_u8(qblob), np.ascontiguousarray(qoff, np.int64),
                       _as_u8(tblob), np.ascontiguousarray(toff, np.int64),
                       n, match, mismatch, gap, 1 if edit_mode else 0,
                       n_threads, out, out_off, counts)
    return out.reshape(-1, 2), out_off, counts


def align_batch_percol(qblob, qoff, tblob, toff, del_blob, match, mismatch,
                       gap, n_threads):
    """Host NW with per-column deletion costs (del_blob indexed by toff)."""
    lib = get_lib()
    n = len(qoff) - 1
    qlen = np.diff(np.asarray(qoff))
    tlen = np.diff(np.asarray(toff))
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(qlen + tlen + 2, out=out_off[1:])
    out = np.zeros(int(out_off[-1]) * 2, np.int32)
    counts = np.zeros(n, np.int64)
    del_blob = np.ascontiguousarray(del_blob, np.int32)
    lib.rt_align_batch_percol(
        _as_u8(qblob), np.ascontiguousarray(qoff, np.int64), _as_u8(tblob),
        np.ascontiguousarray(toff, np.int64),
        del_blob.ctypes.data_as(C.c_void_p), n, match, mismatch, gap, 0,
        n_threads, out, out_off, counts)
    return out.reshape(-1, 2), out_off, counts


def walk_moves_batch(moves, m, n, m_cap, n_cap, w_band, n_threads):
    """moves: (B, m_cap//16, w_band) int32. Returns (ops, offsets, counts);
    counts[i] == -1 flags a band escape."""
    lib = get_lib()
    B = len(m)
    m = np.ascontiguousarray(m, np.int64)
    n = np.ascontiguousarray(n, np.int64)
    out_off = np.zeros(B + 1, np.int64)
    np.cumsum(m + n + 2, out=out_off[1:])
    out = np.zeros(int(out_off[-1]) * 2, np.int32)
    counts = np.zeros(B, np.int64)
    lib.rt_walk_moves_batch(
        np.ascontiguousarray(moves, np.int32).reshape(-1), m, n, B, m_cap,
        n_cap, w_band, n_threads, out, out_off, counts)
    return out.reshape(-1, 2), out_off, counts


def breaking_points_from_ops_batch(ops_blob, ops_off, ops_count, strand,
                                   q_begin, q_end, q_length, t_begin, t_end,
                                   window_length, n_threads):
    """Breaking points from precomputed op lists. Returns (quads, off, counts)."""
    lib = get_lib()
    n = len(strand)
    max_quads = (np.asarray(t_end) - np.asarray(t_begin)) // window_length + 2
    quad_off = np.zeros(n + 1, np.int64)
    np.cumsum(max_quads, out=quad_off[1:])
    out = np.zeros(int(quad_off[-1]) * 4, np.int64)
    counts = np.zeros(n, np.int64)
    lib.rt_breaking_points_from_ops_batch(
        np.ascontiguousarray(ops_blob, np.int32).reshape(-1),
        np.ascontiguousarray(ops_off, np.int64),
        np.ascontiguousarray(ops_count, np.int64), _as_u8(strand),
        np.ascontiguousarray(q_begin, np.int64),
        np.ascontiguousarray(q_end, np.int64),
        np.ascontiguousarray(q_length, np.int64),
        np.ascontiguousarray(t_begin, np.int64),
        np.ascontiguousarray(t_end, np.int64), n, window_length, n_threads,
        out, quad_off, counts)
    return out.reshape(-1, 4), quad_off, counts


def opstream_to_ops_batch(codes, m, n, n_threads):
    """codes: (B, max_steps) int8 backward op streams from the device walk.
    Returns (ops flat (sum,2) int32, offsets, counts)."""
    lib = get_lib()
    B, max_steps = codes.shape
    m = np.asarray(m)
    n = np.asarray(n)
    out_off = np.zeros(B + 1, np.int64)
    np.cumsum(m + n + 2, out=out_off[1:])
    out = np.zeros(int(out_off[-1]) * 2, np.int32)
    counts = np.zeros(B, np.int64)
    lib.rt_opstream_to_ops_batch(
        np.ascontiguousarray(codes, np.int8), B, max_steps, n_threads, out,
        out_off, counts)
    return out.reshape(-1, 2), out_off, counts


def _opstream_common(fn, codes, budget, m, n, n_threads, dst, dst_off):
    """Shared driver for the op-stream decoders. Default: allocate a packed
    (m+n+2)-capacity blob and return (ops (sum,2) int32, offsets, counts).
    With dst/dst_off, decode IN PLACE: row i's ops land at dst[dst_off[i]:]
    with capacity `budget` runs (one event/step yields at most one run), so
    the caller's final per-item layout is written directly — no gather,
    no per-chunk allocation. Returns (dst, dst_off, counts) then."""
    B = codes.shape[0]
    if dst is None:
        m = np.asarray(m)
        n = np.asarray(n)
        dst_off = np.zeros(B + 1, np.int64)
        np.cumsum(m + n + 2, out=dst_off[1:])
        dst = np.empty((int(dst_off[-1]), 2), np.int32)
        caps = None
    else:
        assert dst.dtype == np.int32 and dst.ndim == 2 and dst.shape[1] == 2
        dst_off = np.ascontiguousarray(dst_off, np.int64)
        # a real stream yields <= m+n runs, but an escaped (garbage) stream
        # can fill the whole budget — clamp to the slot size so truncation,
        # not overflow, is the worst case (escaped rows are re-aligned on
        # the host and overwritten anyway)
        caps = np.minimum(np.int64(budget),
                          np.asarray(m, np.int64) + np.asarray(n, np.int64)
                          + 2)
    counts = np.empty(B, np.int64)
    fn(_as_u8(codes), B, budget, n_threads, dst.reshape(-1),
       dst_off, None if caps is None else caps.ctypes.data_as(C.c_void_p),
       counts)
    return dst, dst_off, counts


def opstream_packed_to_ops_batch(codes, max_steps, m, n, n_threads,
                                 dst=None, dst_off=None):
    """codes: (B, max_steps//4) uint8 packed backward op streams (4 steps per
    byte) from the device walk. Returns (ops flat (sum,2) int32, offsets,
    counts); see _opstream_common for the in-place mode."""
    return _opstream_common(get_lib().rt_opstream_packed_to_ops_batch,
                            codes, max_steps, m, n, n_threads, dst, dst_off)


def opstream_rle_to_ops_batch(codes, max_events, m, n, n_threads,
                              dst=None, dst_off=None):
    """codes: (B, max_events) uint8 backward RLE event streams from the
    device RLE walk (0 = skip, 1..200 = diagonal run, 201 = insertion,
    202 = deletion). Returns (ops flat (sum,2) int32, offsets, counts);
    see _opstream_common for the in-place mode."""
    return _opstream_common(get_lib().rt_opstream_rle_to_ops_batch,
                            codes, max_events, m, n, n_threads, dst, dst_off)


def opstream_rows_to_ops_batch(codes, budget, m, n, n_threads,
                               dst=None, dst_off=None):
    """codes: (B, m_cap + 2) uint8 — the FULL nw_kernel.walk_rows_t
    payload (one record byte per query row, the final-deletions byte,
    then the escape byte; the decoder reads budget - 2 = m_cap records
    and the final-deletions byte and ignores the escape column). budget
    must be m_cap + 2. Returns (ops flat (sum,2) int32, offsets,
    counts); see _opstream_common for the in-place mode."""
    return _opstream_common(get_lib().rt_opstream_rows_to_ops_batch,
                            codes, budget, m, n, n_threads, dst, dst_off)


def pack_rows(blob, starts, ends, cap, fill, n_threads, dtype=np.int8):
    """Pad blob slices [starts[i], ends[i]) into a dense (B, cap) matrix of
    `dtype` (int8/uint8) with `fill` in the tail (threaded native memcpy)."""
    lib = get_lib()
    B = len(starts)
    out = np.empty((B, cap), np.uint8)
    lib.rt_pack_rows(_as_u8(blob.view(np.uint8)),
                     np.ascontiguousarray(starts, np.int64),
                     np.ascontiguousarray(ends, np.int64), B, cap,
                     np.uint8(fill & 0xFF if isinstance(fill, int) else fill),
                     out, n_threads)
    return out.view(dtype)


def pack_rows_nib(blob, starts, ends, cap, fill, n_threads):
    """pack_rows fused with the nibble uplink packing: returns the
    (B, cap//2) uint8 matrix nw_kernel.pack_codes4 would produce, in one
    native pass."""
    lib = get_lib()
    B = len(starts)
    out = np.empty((B, cap // 2), np.uint8)
    lib.rt_pack_rows_nib(_as_u8(blob.view(np.uint8)),
                         np.ascontiguousarray(starts, np.int64),
                         np.ascontiguousarray(ends, np.int64), B, cap,
                         np.uint8(fill), out, n_threads)
    return out


def pack_rows_bits(blob, starts, ends, cap, n_threads):
    """pack_rows fused with the deletion-cost bitmask packing: returns the
    (B, cap//8) uint8 matrix nw_kernel.pack_delbits would produce (bit set
    iff the cost byte is nonzero; pad bits set)."""
    lib = get_lib()
    B = len(starts)
    out = np.empty((B, cap // 8), np.uint8)
    lib.rt_pack_rows_bits(_as_u8(blob.view(np.uint8)),
                          np.ascontiguousarray(starts, np.int64),
                          np.ascontiguousarray(ends, np.int64), B, cap,
                          out, n_threads)
    return out


def compose_slots(slots, bb_off, lens, local, src_off, new_len, n_threads):
    """Refinement-state slot composition: out[sum(new_len)] with
    out[dst_off[z]+j] = slots[bb_off[z] + min(local[src_off[z]+j],
    lens[z]-1)] — one threaded native pass instead of the numpy
    repeat/fancy-index chain."""
    lib = get_lib()
    n = len(new_len)
    new_len = np.ascontiguousarray(new_len, np.int64)
    dst_off = np.zeros(n + 1, np.int64)
    np.cumsum(new_len, out=dst_off[1:])
    out = np.empty(int(dst_off[-1]), np.int64)
    lib.rt_compose_slots(
        np.ascontiguousarray(slots, np.int64),
        np.ascontiguousarray(bb_off, np.int64),
        np.ascontiguousarray(lens, np.int64),
        np.ascontiguousarray(local, np.int32),
        np.ascontiguousarray(src_off, np.int64), new_len, dst_off, n, out,
        n_threads)
    return out, dst_off


def project_spans(slots, bb_off, item_wz, begin, end, n_threads):
    """Per-item span projection onto each window's ascending slot run
    (binary search + the reference's 1% full-span rule,
    /root/reference/src/window.cpp:87-92). Returns clamped (s0, s1)."""
    lib = get_lib()
    n = len(item_wz)
    s0 = np.empty(n, np.int64)
    s1 = np.empty(n, np.int64)
    lib.rt_project_spans(
        np.ascontiguousarray(slots, np.int64),
        np.ascontiguousarray(bb_off, np.int64),
        np.ascontiguousarray(item_wz, np.int64),
        np.ascontiguousarray(begin, np.int64),
        np.ascontiguousarray(end, np.int64), n, s0, s1, n_threads)
    return s0, s1


def gather_ranges(src, starts, lens, n_threads, dst=None, dst_off=None):
    """Threaded ranged gather: concatenate src[starts[i] : starts[i]+lens[i])
    slices. With dst/dst_off, scatter the ranges into an existing array at
    element offsets dst_off instead (returns dst). Replaces
    flat-index-array numpy gathers in the stage hot loops."""
    lib = get_lib()
    src = np.ascontiguousarray(src)
    lens = np.ascontiguousarray(lens, np.int64)
    if dst is None:
        dst_off = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=dst_off[1:])
        shape = (int(dst_off[-1]),) + src.shape[1:]
        dst = np.empty(shape, src.dtype)
    elem = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.rt_gather_ranges(
        _as_u8(src.reshape(-1).view(np.uint8)), elem,
        np.ascontiguousarray(starts, np.int64), lens,
        np.ascontiguousarray(dst_off, np.int64), len(lens),
        _as_u8(dst.reshape(-1).view(np.uint8)), n_threads)
    return dst


def poa_round_batch(cur_blob, cur_off, curw_blob, layer_off, lay_blob,
                    lay_data_off, layw_blob, lay_span_begin, ops_blob,
                    ops_off, final_round, tgs, trim, gap, cand_frac, cand_min,
                    max_expand, win_id, win_rank, n_threads, out_capacity,
                    with_final=False, ops_cnt=None):
    """One POA merge round over a window batch (device-driver mode).

    ops_off holds per-item offsets into ops_blob; when ops_cnt is given it
    holds per-item run counts (padded/non-contiguous ops layouts — the
    in-place decode mode), otherwise counts are the offset differences.
    Returns (out_blob, out_off, out_len, out_del, out_slots, polished).
    With with_final=True (intermediate rounds only), additionally returns
    (fin_blob, fin_len, fin_polished, conv): the would-be-final consensus
    off the same graph (same out_off layout) and per-window convergence
    flags -- a converged window's fin output IS its final consensus, so the
    caller can retire it without another merge."""
    lib = get_lib()
    n_windows = len(cur_off) - 1
    out_off = np.zeros(n_windows + 1, np.int64)
    np.cumsum(out_capacity, out=out_off[1:])
    total = int(out_off[-1])
    out_blob = np.empty(total, np.uint8)
    out_del = np.empty(total, np.int32)
    out_slots = np.empty(total, np.int32)
    out_len = np.empty(n_windows, np.int64)
    out_pol = np.empty(n_windows, np.uint8)
    oc = None
    if ops_cnt is not None:
        ops_cnt = np.ascontiguousarray(ops_cnt, np.int64)
        oc = ops_cnt.ctypes.data_as(C.c_void_p)
    want_fin = with_final and not final_round
    if want_fin:
        fin_blob = np.empty(total, np.uint8)
        fin_len = np.empty(n_windows, np.int64)
        fin_pol = np.empty(n_windows, np.uint8)
        conv = np.empty(n_windows, np.uint8)
        fb = fin_blob.ctypes.data_as(C.c_void_p)
        fl = fin_len.ctypes.data_as(C.c_void_p)
        fp = fin_pol.ctypes.data_as(C.c_void_p)
        cv = conv.ctypes.data_as(C.c_void_p)
    else:
        fb = fl = fp = cv = None
    lib.rt_poa_round_batch(
        n_windows, _as_u8(cur_blob), np.ascontiguousarray(cur_off, np.int64),
        np.ascontiguousarray(curw_blob, np.int32),
        np.ascontiguousarray(layer_off, np.int64), _as_u8(lay_blob),
        np.ascontiguousarray(lay_data_off, np.int64),
        np.ascontiguousarray(layw_blob, np.int32),
        np.ascontiguousarray(lay_span_begin, np.int32),
        np.ascontiguousarray(ops_blob, np.int32).reshape(-1),
        np.ascontiguousarray(ops_off, np.int64), oc,
        1 if final_round else 0,
        1 if tgs else 0, 1 if trim else 0, gap, cand_frac, cand_min,
        max_expand, np.ascontiguousarray(win_id, np.int64),
        np.ascontiguousarray(win_rank, np.int32), n_threads, out_blob,
        out_off, out_len, out_del, out_slots, out_pol, fb, fl, fp, cv)
    if want_fin:
        return (out_blob, out_off, out_len, out_del, out_slots, out_pol,
                fin_blob, fin_len, fin_pol, conv)
    return out_blob, out_off, out_len, out_del, out_slots, out_pol


def consensus_batch(bb_blob, bb_off, bbw_blob, win_id, win_rank, layer_off,
                    lay_blob, lay_data_off, layw_blob, lay_begin, lay_end,
                    ops_blob, ops_off, tgs, trim, match, mismatch, gap,
                    n_threads, out_capacity_per_window, passes=4,
                    cand_frac=0.15, cand_min=2):
    """Returns (consensus blob, out_off, lengths, polished)."""
    lib = get_lib()
    n_windows = len(bb_off) - 1
    out_off = np.zeros(n_windows + 1, np.int64)
    np.cumsum(out_capacity_per_window, out=out_off[1:])
    out_blob = np.zeros(int(out_off[-1]), np.uint8)
    out_len = np.zeros(n_windows, np.int64)
    out_pol = np.zeros(n_windows, np.uint8)
    ops_ptr = None
    ops_off_ptr = None
    if ops_blob is not None:
        ops_blob = np.ascontiguousarray(ops_blob, np.int32)
        ops_off = np.ascontiguousarray(ops_off, np.int64)
        ops_ptr = ops_blob.ctypes.data_as(C.c_void_p)
        ops_off_ptr = ops_off.ctypes.data_as(C.c_void_p)
    lib.rt_consensus_batch(
        n_windows, _as_u8(bb_blob), np.ascontiguousarray(bb_off, np.int64),
        np.ascontiguousarray(bbw_blob, np.int32),
        np.ascontiguousarray(win_id, np.int64),
        np.ascontiguousarray(win_rank, np.int32),
        np.ascontiguousarray(layer_off, np.int64), _as_u8(lay_blob),
        np.ascontiguousarray(lay_data_off, np.int64),
        np.ascontiguousarray(layw_blob, np.int32),
        np.ascontiguousarray(lay_begin, np.int32),
        np.ascontiguousarray(lay_end, np.int32), ops_ptr, ops_off_ptr,
        1 if tgs else 0, 1 if trim else 0, match, mismatch, gap, passes,
        cand_frac, cand_min, n_threads, out_blob, out_off, out_len, out_pol)
    return out_blob, out_off, out_len, out_pol


def poa_prof_ns():
    """RT_POA_PROF=1 merge-phase profile readback: (build_ns, bundle_ns,
    emit_ns) accumulated across all poa_round merges in this process."""
    lib = get_lib()
    lib.rt_poa_prof_ns.argtypes = [np.ctypeslib.ndpointer(
        np.int64, flags="C_CONTIGUOUS")]
    out = np.zeros(3, np.int64)
    lib.rt_poa_prof_ns(out)
    return tuple(int(x) for x in out)
