// C API consumed from Python via ctypes (racon_tpu_torch/native/bindings.py).
// Handle-based two-call pattern for variable-size results: parse -> sizes,
// export -> caller-allocated numpy buffers.

#include "align.hpp"
#include "common.hpp"
#include "fastx.hpp"
#include "overlapio.hpp"
#include "poa.hpp"

#include <algorithm>
#include <cstring>
#include <mutex>

extern "C" {

void rt_align_batch_percol(const uint8_t* qblob, const int64_t* qoff,
                           const uint8_t* tblob, const int64_t* toff,
                           const int32_t* del_blob, int64_t n, int32_t match,
                           int32_t mismatch, int32_t gap, int32_t edit_mode,
                           int32_t n_threads, int32_t* out_ops,
                           const int64_t* out_ops_off, int64_t* out_ops_count);

// ------------------------------------------------------------------ //
// error reporting (per-call last error; coarse but sufficient: parsing
// happens single-threaded from python)
// ------------------------------------------------------------------ //

static std::string g_last_error;
static std::mutex g_err_mutex;

const char* rt_last_error() {
    return g_last_error.c_str();
}

static void set_error(const std::string& e) {
    std::lock_guard<std::mutex> lock(g_err_mutex);
    g_last_error = e;
}

// ------------------------------------------------------------------ //
// fastx
// ------------------------------------------------------------------ //

void* rt_parse_fastx(const char* path, int32_t is_fastq, int64_t* n_records,
                     int64_t* name_bytes, int64_t* data_bytes,
                     int64_t* qual_bytes) {
    auto* res = new rt::FastxResult();
    std::string err;
    if (!rt::parse_fastx(path, is_fastq != 0, *res, err)) {
        set_error(err);
        delete res;
        return nullptr;
    }
    *n_records = res->size();
    *name_bytes = static_cast<int64_t>(res->names.size());
    *data_bytes = static_cast<int64_t>(res->data.size());
    *qual_bytes = static_cast<int64_t>(res->quals.size());
    return res;
}

void rt_fastx_export(void* h, uint8_t* name_blob, int64_t* name_off,
                     uint8_t* data_blob, int64_t* data_off, uint8_t* qual_blob,
                     int64_t* qual_off) {
    auto* res = static_cast<rt::FastxResult*>(h);
    memcpy(name_blob, res->names.data(), res->names.size());
    memcpy(data_blob, res->data.data(), res->data.size());
    memcpy(qual_blob, res->quals.data(), res->quals.size());
    memcpy(name_off, res->name_off.data(),
           res->name_off.size() * sizeof(int64_t));
    memcpy(data_off, res->data_off.data(),
           res->data_off.size() * sizeof(int64_t));
    memcpy(qual_off, res->qual_off.data(),
           res->qual_off.size() * sizeof(int64_t));
}

void rt_fastx_free(void* h) {
    delete static_cast<rt::FastxResult*>(h);
}

// --- chunked streaming (bioparser parse(dst, max_bytes) role) ---

void* rt_fastx_stream_open(const char* path, int32_t is_fastq) {
    std::string err;
    rt::FastxStream* s = rt::fastx_stream_open(path, is_fastq != 0, err);
    if (!s) set_error(err);
    return s;
}

void* rt_fastx_stream_next(void* sh, int64_t max_bytes, int64_t* n_records,
                           int64_t* name_bytes, int64_t* data_bytes,
                           int64_t* qual_bytes, int32_t* eof) {
    auto* s = static_cast<rt::FastxStream*>(sh);
    auto* res = new rt::FastxResult();
    std::string err;
    bool at_eof = false;
    if (!rt::fastx_stream_next(s, max_bytes, *res, err, &at_eof)) {
        set_error(err);
        delete res;
        return nullptr;
    }
    *eof = at_eof ? 1 : 0;
    *n_records = res->size();
    *name_bytes = static_cast<int64_t>(res->names.size());
    *data_bytes = static_cast<int64_t>(res->data.size());
    *qual_bytes = static_cast<int64_t>(res->quals.size());
    return res;
}

void rt_fastx_stream_free(void* sh) {
    rt::fastx_stream_free(static_cast<rt::FastxStream*>(sh));
}

// ------------------------------------------------------------------ //
// overlaps
// ------------------------------------------------------------------ //

// --- chunked streaming (bioparser parse(dst, max_bytes) role) ---

void* rt_overlap_stream_open(const char* path, int32_t fmt) {
    std::string err;
    rt::OverlapStream* s = rt::overlap_stream_open(path, fmt, err);
    if (!s) set_error(err);
    return s;
}

// returns an OverlapResult handle for the next chunk (consume with
// rt_overlaps_export + rt_overlaps_free); nullptr on error. *eof is set
// when the file is exhausted (the returned chunk may still hold records).
void* rt_overlap_stream_next(void* sh, int64_t max_bytes, int64_t* n_records,
                             int64_t* qname_bytes, int64_t* tname_bytes,
                             int64_t* cigar_bytes, int32_t* eof) {
    auto* s = static_cast<rt::OverlapStream*>(sh);
    auto* res = new rt::OverlapResult();
    std::string err;
    bool at_eof = false;
    if (!rt::overlap_stream_next(s, max_bytes, *res, err, &at_eof)) {
        set_error(err);
        delete res;
        return nullptr;
    }
    *eof = at_eof ? 1 : 0;
    *n_records = res->size();
    *qname_bytes = static_cast<int64_t>(res->qnames.size());
    *tname_bytes = static_cast<int64_t>(res->tnames.size());
    *cigar_bytes = static_cast<int64_t>(res->cigars.size());
    return res;
}

void rt_overlap_stream_free(void* sh) {
    rt::overlap_stream_free(static_cast<rt::OverlapStream*>(sh));
}

void* rt_parse_overlaps(const char* path, int32_t fmt, int64_t* n_records,
                        int64_t* qname_bytes, int64_t* tname_bytes,
                        int64_t* cigar_bytes) {
    auto* res = new rt::OverlapResult();
    std::string err;
    if (!rt::parse_overlaps(path, fmt, *res, err)) {
        set_error(err);
        delete res;
        return nullptr;
    }
    *n_records = res->size();
    *qname_bytes = static_cast<int64_t>(res->qnames.size());
    *tname_bytes = static_cast<int64_t>(res->tnames.size());
    *cigar_bytes = static_cast<int64_t>(res->cigars.size());
    return res;
}

void rt_overlaps_export(void* h, uint8_t* qname_blob, int64_t* qname_off,
                        uint8_t* tname_blob, int64_t* tname_off,
                        uint8_t* cigar_blob, int64_t* cigar_off, int64_t* q_id,
                        int64_t* t_id, int64_t* q_begin, int64_t* q_end,
                        int64_t* q_length, int64_t* t_begin, int64_t* t_end,
                        int64_t* t_length, int64_t* length, uint8_t* strand,
                        uint8_t* is_valid, double* error) {
    auto* r = static_cast<rt::OverlapResult*>(h);
    const int64_t n = r->size();
    memcpy(qname_blob, r->qnames.data(), r->qnames.size());
    memcpy(tname_blob, r->tnames.data(), r->tnames.size());
    memcpy(cigar_blob, r->cigars.data(), r->cigars.size());
    memcpy(qname_off, r->qname_off.data(), (n + 1) * sizeof(int64_t));
    memcpy(tname_off, r->tname_off.data(), (n + 1) * sizeof(int64_t));
    memcpy(cigar_off, r->cigar_off.data(), (n + 1) * sizeof(int64_t));
    memcpy(q_id, r->q_id.data(), n * sizeof(int64_t));
    memcpy(t_id, r->t_id.data(), n * sizeof(int64_t));
    memcpy(q_begin, r->q_begin.data(), n * sizeof(int64_t));
    memcpy(q_end, r->q_end.data(), n * sizeof(int64_t));
    memcpy(q_length, r->q_length.data(), n * sizeof(int64_t));
    memcpy(t_begin, r->t_begin.data(), n * sizeof(int64_t));
    memcpy(t_end, r->t_end.data(), n * sizeof(int64_t));
    memcpy(t_length, r->t_length.data(), n * sizeof(int64_t));
    memcpy(length, r->length.data(), n * sizeof(int64_t));
    memcpy(strand, r->strand.data(), n);
    memcpy(is_valid, r->is_valid.data(), n);
    memcpy(error, r->error.data(), n * sizeof(double));
}

void rt_overlaps_free(void* h) {
    delete static_cast<rt::OverlapResult*>(h);
}

// ------------------------------------------------------------------ //
// alignment
// ------------------------------------------------------------------ //

int64_t rt_edit_distance(const uint8_t* a, int64_t alen, const uint8_t* b,
                         int64_t blen) {
    return rt::edit_distance(a, alen, b, blen);
}

// batched overlap alignment -> breaking points
// out_off[i] = quad offset for item i (caller sized); out_counts[i] = quads
void rt_breaking_points_batch(
    const uint8_t* qblob, const int64_t* qoff, const uint8_t* tblob,
    const int64_t* toff, const uint8_t* strand, const int64_t* q_begin,
    const int64_t* q_end, const int64_t* q_length, const int64_t* t_begin,
    const int64_t* t_end, int64_t n, int32_t window_length, int32_t n_threads,
    int64_t* out_quads, const int64_t* out_off, int64_t* out_counts) {
    rt::parallel_for(n, n_threads, [&](int64_t i, int32_t) {
        std::vector<rt::OpRun> ops;
        const uint8_t* q = qblob + qoff[i];
        const int64_t qlen = qoff[i + 1] - qoff[i];
        const uint8_t* t = tblob + toff[i];
        const int64_t tlen = toff[i + 1] - toff[i];
        rt::edit_align(q, qlen, t, tlen, ops);
        out_counts[i] = rt::breaking_points(
            ops.data(), static_cast<int64_t>(ops.size()), strand[i] != 0,
            q_begin[i], q_end[i], q_length[i], t_begin[i], t_end[i],
            window_length, out_quads + out_off[i] * 4,
            out_off[i + 1] - out_off[i]);
    });
}

// batched pairwise alignment returning op lists (used by tests and by the
// consensus stage when alignments are computed on host)
// ops packed per item: out_ops[out_ops_off[i]*2 ...] as (op, run) int32 pairs
void rt_align_batch(const uint8_t* qblob, const int64_t* qoff,
                    const uint8_t* tblob, const int64_t* toff, int64_t n,
                    int32_t match, int32_t mismatch, int32_t gap,
                    int32_t edit_mode, int32_t n_threads, int32_t* out_ops,
                    const int64_t* out_ops_off, int64_t* out_ops_count) {
    rt_align_batch_percol(qblob, qoff, tblob, toff, nullptr, n, match,
                          mismatch, gap, edit_mode, n_threads, out_ops,
                          out_ops_off, out_ops_count);
}

// del_blob (nullable): per-target-column deletion costs, indexed by toff
void rt_align_batch_percol(const uint8_t* qblob, const int64_t* qoff,
                           const uint8_t* tblob, const int64_t* toff,
                           const int32_t* del_blob, int64_t n, int32_t match,
                           int32_t mismatch, int32_t gap, int32_t edit_mode,
                           int32_t n_threads, int32_t* out_ops,
                           const int64_t* out_ops_off,
                           int64_t* out_ops_count) {
    rt::parallel_for(n, n_threads, [&](int64_t i, int32_t) {
        std::vector<rt::OpRun> ops;
        std::vector<uint8_t> moves;
        std::vector<int32_t> h_prev, h_cur;
        const uint8_t* q = qblob + qoff[i];
        const int64_t qlen = qoff[i + 1] - qoff[i];
        const uint8_t* t = tblob + toff[i];
        const int64_t tlen = toff[i + 1] - toff[i];
        if (edit_mode) {
            rt::edit_align(q, qlen, t, tlen, ops);
        } else if (del_blob != nullptr) {
            rt::nw_score_align_percol(q, qlen, t, tlen, del_blob + toff[i],
                                      match, mismatch, gap, ops, moves,
                                      h_prev, h_cur);
        } else {
            rt::nw_score_align(q, qlen, t, tlen, match, mismatch, gap, ops,
                               moves, h_prev, h_cur);
        }
        const int64_t cap = out_ops_off[i + 1] - out_ops_off[i];
        const int64_t cnt =
            std::min<int64_t>(cap, static_cast<int64_t>(ops.size()));
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        for (int64_t k = 0; k < cnt; ++k) {
            dst[k * 2] = ops[k].op;
            dst[k * 2 + 1] = ops[k].run;
        }
        out_ops_count[i] = cnt;
    });
}

// walk a batch of device-produced packed move planes into op lists;
// out_counts[i] = -1 marks a band escape (caller realigns on host)
void rt_walk_moves_batch(const int32_t* moves, const int64_t* m,
                         const int64_t* n, int64_t n_items, int64_t m_cap,
                         int64_t n_cap, int64_t w_band, int32_t n_threads,
                         int32_t* out_ops, const int64_t* out_ops_off,
                         int64_t* out_ops_count) {
    const int64_t plane = (m_cap / 16) * w_band;
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        std::vector<rt::OpRun> ops;
        const int64_t r = rt::walk_moves(moves + i * plane, m[i], n[i], m_cap,
                                         n_cap, w_band, ops);
        if (r < 0) {
            out_ops_count[i] = -1;
            return;
        }
        const int64_t cap = out_ops_off[i + 1] - out_ops_off[i];
        const int64_t cnt =
            std::min<int64_t>(cap, static_cast<int64_t>(ops.size()));
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        for (int64_t k = 0; k < cnt; ++k) {
            dst[k * 2] = ops[k].op;
            dst[k * 2 + 1] = ops[k].run;
        }
        out_ops_count[i] = cnt;
    });
}

// one POA merge round for a batch of windows: build graphs from per-layer op
// lists (spans in cur coordinates), emit final consensus or the expanded
// backbone for the next round (seq + per-column del costs + local slots).
void rt_poa_round_batch(
    int64_t n_windows, const uint8_t* cur_blob, const int64_t* cur_off,
    const int32_t* curw_blob, const int64_t* layer_off, const uint8_t* lay_blob,
    const int64_t* lay_data_off, const int32_t* layw_blob,
    const int32_t* lay_span_begin, const int32_t* ops_blob,
    const int64_t* ops_off, const int64_t* ops_cnt, int32_t final_round,
    int32_t tgs, int32_t trim,
    int32_t gap, double cand_frac, int32_t cand_min, int64_t max_expand,
    const int64_t* win_id, const int32_t* win_rank, int32_t n_threads,
    uint8_t* out_blob, const int64_t* out_off, int64_t* out_len,
    int32_t* out_del_blob, int32_t* out_slots_blob, uint8_t* out_polished,
    uint8_t* fin_blob, int64_t* fin_len, uint8_t* fin_polished,
    uint8_t* out_conv) {
    rt::RefineParams rp;
    rp.cand_frac = cand_frac;
    rp.cand_min = cand_min;
    rt::parallel_for(n_windows, n_threads, [&](int64_t w, int32_t) {
        const int64_t len = cur_off[w + 1] - cur_off[w];
        rt::RoundState st;
        st.cur.assign(cur_blob + cur_off[w], cur_blob + cur_off[w + 1]);
        st.cur_w.assign(curw_blob + cur_off[w], curw_blob + cur_off[w + 1]);
        st.cur_slots.resize(len);
        for (int64_t c = 0; c < len; ++c) {
            st.cur_slots[c] = static_cast<int32_t>(c);  // local slots
        }
        const int64_t l0 = layer_off[w], l1 = layer_off[w + 1];
        std::vector<rt::LayerView> layers(l1 - l0);
        for (int64_t l = l0; l < l1; ++l) {
            rt::LayerView& v = layers[l - l0];
            v.data = lay_blob + lay_data_off[l];
            v.weights = layw_blob + lay_data_off[l];
            v.len = lay_data_off[l + 1] - lay_data_off[l];
            v.begin = lay_span_begin[l];
            v.end = 0;  // unused when ops are given
            v.ops = reinterpret_cast<const rt::OpRun*>(ops_blob) + ops_off[l];
            v.n_ops = ops_cnt ? ops_cnt[l] : ops_off[l + 1] - ops_off[l];
        }
        bool polished = false;
        const int64_t cap = out_off[w + 1] - out_off[w];
        // cap the expansion to both the caller budget and the device n_cap
        rp.max_growth_num = 2;
        bool fin_pol = false, conv = false;
        int64_t fl = 0;
        const bool want_fin = !final_round && fin_blob != nullptr;
        int64_t nlen = rt::poa_round(
            st, l1 - l0, layers.data(), final_round != 0, rp, tgs != 0,
            trim != 0, gap, out_blob + out_off[w], cap, &polished, win_id[w],
            win_rank[w], want_fin ? fin_blob + out_off[w] : nullptr, cap,
            want_fin ? &fl : nullptr, want_fin ? &fin_pol : nullptr,
            want_fin ? &conv : nullptr);
        if (!final_round) {
            nlen = std::min<int64_t>(
                nlen, std::min<int64_t>(cap, max_expand));
            memcpy(out_blob + out_off[w], st.cur.data(), nlen);
            memcpy(out_del_blob + out_off[w], st.cur_del.data(),
                   nlen * sizeof(int32_t));
            memcpy(out_slots_blob + out_off[w], st.cur_slots.data(),
                   nlen * sizeof(int32_t));
        }
        if (want_fin) {
            fin_len[w] = fl;
            fin_polished[w] = fin_pol ? 1 : 0;
            out_conv[w] = conv ? 1 : 0;
        }
        out_len[w] = nlen;
        out_polished[w] = polished ? 1 : 0;
    });
}

// ------------------------------------------------------------------ //
// window consensus
// ------------------------------------------------------------------ //

void rt_consensus_batch(
    int64_t n_windows, const uint8_t* bb_blob, const int64_t* bb_off,
    const int32_t* bbw_blob, const int64_t* win_id, const int32_t* win_rank,
    const int64_t* layer_off, const uint8_t* lay_blob,
    const int64_t* lay_data_off, const int32_t* layw_blob,
    const int32_t* lay_begin, const int32_t* lay_end, const int32_t* ops_blob,
    const int64_t* ops_off, int32_t tgs, int32_t trim, int32_t match,
    int32_t mismatch, int32_t gap, int32_t passes, double cand_frac,
    int32_t cand_min, int32_t n_threads, uint8_t* out_blob,
    const int64_t* out_off, int64_t* out_len, uint8_t* out_polished) {
    rt::RefineParams rp;
    rp.passes = passes;
    rp.cand_frac = cand_frac;
    rp.cand_min = cand_min;
    rt::parallel_for(n_windows, n_threads, [&](int64_t w, int32_t) {
        rt::PoaScratch scratch;
        const int64_t l0 = layer_off[w];
        const int64_t l1 = layer_off[w + 1];
        std::vector<rt::LayerView> layers;
        layers.reserve(l1 - l0);
        for (int64_t l = l0; l < l1; ++l) {
            rt::LayerView v;
            v.data = lay_blob + lay_data_off[l];
            v.weights = layw_blob + lay_data_off[l];
            v.len = lay_data_off[l + 1] - lay_data_off[l];
            v.begin = lay_begin[l];
            v.end = lay_end[l];
            if (ops_blob != nullptr && ops_off != nullptr) {
                v.ops = reinterpret_cast<const rt::OpRun*>(ops_blob) + ops_off[l];
                v.n_ops = ops_off[l + 1] - ops_off[l];
            } else {
                v.ops = nullptr;
                v.n_ops = 0;
            }
            layers.push_back(v);
        }
        bool polished = false;
        out_len[w] = rt::consensus_window(
            bb_blob + bb_off[w], static_cast<int32_t>(bb_off[w + 1] - bb_off[w]),
            bbw_blob + bb_off[w], l1 - l0, layers.data(), tgs != 0, trim != 0,
            match, mismatch, gap, rp, out_blob + out_off[w],
            out_off[w + 1] - out_off[w], &polished, win_id[w], win_rank[w],
            scratch);
        out_polished[w] = polished ? 1 : 0;
    });
}

}  // extern "C"

extern "C" {

// RLE a batch of backward device op streams (codes 0/1/2, 3 = skip) into
// forward op lists
void rt_opstream_to_ops_batch(const int8_t* codes, int64_t n_items,
                              int64_t max_steps, int32_t n_threads,
                              int32_t* out_ops, const int64_t* out_ops_off,
                              int64_t* out_ops_count) {
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        const int8_t* s = codes + i * max_steps;
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        const int64_t cap = out_ops_off[i + 1] - out_ops_off[i];
        int64_t cnt = 0;
        int32_t prev = -1;
        // stream is backward: scan from the end to emit forward runs
        for (int64_t k = max_steps - 1; k >= 0; --k) {
            const int32_t op = s[k];
            if (op == 3) continue;
            if (op == prev && cnt > 0) {
                dst[(cnt - 1) * 2 + 1] += 1;
            } else if (cnt < cap) {
                dst[cnt * 2] = op;
                dst[cnt * 2 + 1] = 1;
                ++cnt;
                prev = op;
            }
        }
        out_ops_count[i] = cnt;
    });
}

// same, but for 2-bit packed streams (4 steps per byte, step k in bits
// [2*(k&3), 2*(k&3)+2) of byte k>>2) — the D2H-light device walk format
void rt_opstream_packed_to_ops_batch(const uint8_t* codes, int64_t n_items,
                                     int64_t max_steps, int32_t n_threads,
                                     int32_t* out_ops,
                                     const int64_t* out_ops_off,
                                     const int64_t* out_ops_cap,
                                     int64_t* out_ops_count) {
    const int64_t stride = max_steps / 4;
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        const uint8_t* s = codes + i * stride;
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        const int64_t cap =
            out_ops_cap ? out_ops_cap[i] : out_ops_off[i + 1] - out_ops_off[i];
        int64_t cnt = 0;
        int32_t prev = -1;
        int64_t k = max_steps - 1;
        while (k >= 0) {
            // all-skip byte groups (0xFF = four 0b11 steps) dominate the
            // pad tail — hop over 8 bytes (32 steps) at a time
            if ((k & 31) == 31 && k >= 31) {
                uint64_t w;
                std::memcpy(&w, s + (k >> 2) - 7, 8);
                if (w == ~uint64_t{0}) {
                    k -= 32;
                    continue;
                }
            }
            const int32_t op = (s[k >> 2] >> (2 * (k & 3))) & 3;
            --k;
            if (op == 3) continue;
            if (op == prev && cnt > 0) {
                dst[(cnt - 1) * 2 + 1] += 1;
            } else if (cnt < cap) {
                dst[cnt * 2] = op;
                dst[cnt * 2 + 1] = 1;
                ++cnt;
                prev = op;
            }
        }
        out_ops_count[i] = cnt;
    });
}

// decode backward RLE event streams from the device walk (byte 0 = skip,
// 1..200 = diagonal run of that length, 201 = one insertion, 202 = one
// deletion) into forward op lists, merging adjacent same-op runs
void rt_opstream_rle_to_ops_batch(const uint8_t* codes, int64_t n_items,
                                  int64_t max_events, int32_t n_threads,
                                  int32_t* out_ops, const int64_t* out_ops_off,
                                  const int64_t* out_ops_cap,
                                  int64_t* out_ops_count) {
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        const uint8_t* s = codes + i * max_events;
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        const int64_t cap =
            out_ops_cap ? out_ops_cap[i] : out_ops_off[i + 1] - out_ops_off[i];
        int64_t cnt = 0;
        int32_t prev = -1;
        int64_t k = max_events - 1;
        while (k >= 0) {
            // zero bytes (skip) fill the pad tail and are common in the
            // body — hop over 8-byte all-zero groups in one compare
            if (k >= 7) {
                uint64_t w;
                std::memcpy(&w, s + k - 7, 8);
                if (w == 0) {
                    k -= 8;
                    continue;
                }
            }
            const uint8_t v = s[k];
            --k;
            if (v == 0) continue;
            int32_t op, len;
            if (v <= 200) { op = 0; len = v; }
            else if (v == 201) { op = 1; len = 1; }
            else { op = 2; len = 1; }
            if (op == prev && cnt > 0) {
                dst[(cnt - 1) * 2 + 1] += len;
            } else if (cnt < cap) {
                dst[cnt * 2] = op;
                dst[cnt * 2 + 1] = len;
                ++cnt;
                prev = op;
            }
        }
        out_ops_count[i] = cnt;
    });
}

// rows-walk decoder: codes row i is the FULL rows payload [rec bytes for
// query rows 1..m_cap, final-deletions byte, escape byte] (width = budget
// = m_cap + 2; passing the whole payload avoids a host-side slice copy).
// rec byte: bits 0-1 0 = inactive row / 1 = diagonal / 2 = up(insertion),
// bits 2-7 = deletion (LEFT) steps taken in the row before the
// transition. Forward op order: final deletions first, then per ascending
// row: transition op, then the row's deletions (the backward emission
// reversed). Same merged (op, len) output as the other decoders. At ONT
// error rates ~90% of records are plain diagonals (byte 0x01), so the
// scan hops 8-byte all-0x01 words in one compare.
void rt_opstream_rows_to_ops_batch(const uint8_t* codes, int64_t n_items,
                                   int64_t budget, int32_t n_threads,
                                   int32_t* out_ops,
                                   const int64_t* out_ops_off,
                                   const int64_t* out_ops_cap,
                                   int64_t* out_ops_count) {
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        const uint8_t* s = codes + i * budget;
        int32_t* dst = out_ops + out_ops_off[i] * 2;
        const int64_t cap =
            out_ops_cap ? out_ops_cap[i] : out_ops_off[i + 1] - out_ops_off[i];
        int64_t cnt = 0;
        int32_t prev = -1;
        auto emit = [&](int32_t op, int32_t len) {
            if (len <= 0) return;
            if (op == prev && cnt > 0) {
                dst[(cnt - 1) * 2 + 1] += len;
            } else if (cnt < cap) {
                dst[cnt * 2] = op;
                dst[cnt * 2 + 1] = len;
                ++cnt;
                prev = op;
            }
        };
        const int64_t nrec = budget - 2;
        emit(2, s[nrec]);  // final (row 0) deletions
        int64_t r = 0;
        while (r < nrec) {
            // run-segmented scan: consume the whole plain-diagonal run
            // (word hops + byte tail) with ONE emit, then one indel record
            const int64_t d0 = r;
            while (r + 8 <= nrec) {
                uint64_t w;
                std::memcpy(&w, s + r, 8);
                if (w != 0x0101010101010101ull) break;
                r += 8;
            }
            while (r < nrec && s[r] == 0x01) ++r;
            emit(0, static_cast<int32_t>(r - d0));
            if (r >= nrec) break;
            const uint8_t v = s[r];
            if (!(v & 3)) break;  // first inactive row: rows r+1.. unused
            ++r;
            emit((v & 3) == 1 ? 0 : 1, 1);
            emit(2, v >> 2);
        }
        out_ops_count[i] = cnt;
    });
}

// pad variable-length blob slices into a dense (n_rows, cap) byte matrix —
// the host-side batch packer for device payloads (threaded memcpy)
void rt_pack_rows(const uint8_t* blob, const int64_t* starts,
                  const int64_t* ends, int64_t n_rows, int64_t cap,
                  uint8_t fill, uint8_t* out, int32_t n_threads) {
    rt::parallel_for(n_rows, n_threads, [&](int64_t i, int32_t) {
        uint8_t* dst = out + i * cap;
        int64_t len = ends[i] - starts[i];
        if (len > cap) len = cap;
        if (len > 0) std::memcpy(dst, blob + starts[i], len);
        if (len < cap) std::memset(dst + len, fill, cap - len);
    });
}

// same, but writes the nibble-packed uplink form directly: out row i is
// (cap/2) bytes, byte k = code[2k] | code[2k+1] << 4 (codes are 0..5 so a
// nibble holds them; pad fills with `fill`). One pass instead of
// pack_rows + a numpy repack, and half the bytes written.
void rt_pack_rows_nib(const uint8_t* blob, const int64_t* starts,
                      const int64_t* ends, int64_t n_rows, int64_t cap,
                      uint8_t fill, uint8_t* out, int32_t n_threads) {
    const int64_t w = cap / 2;
    const uint8_t fill2 = static_cast<uint8_t>(fill | (fill << 4));
    rt::parallel_for(n_rows, n_threads, [&](int64_t i, int32_t) {
        uint8_t* dst = out + i * w;
        const uint8_t* src = blob + starts[i];
        int64_t len = ends[i] - starts[i];
        if (len > cap) len = cap;
        const int64_t full = len / 2;
        for (int64_t k = 0; k < full; ++k) {
            dst[k] = static_cast<uint8_t>(src[2 * k] | (src[2 * k + 1] << 4));
        }
        int64_t k = full;
        if (len & 1) {
            dst[k] = static_cast<uint8_t>(src[len - 1] | (fill << 4));
            ++k;
        }
        if (k < w) std::memset(dst + k, fill2, w - k);
    });
}

// bitmask row packer: out row i is (cap/8) bytes, bit k set iff the cost
// byte at blob[starts[i]+k] is nonzero; pad bits are set (pad columns cost
// the full gap, matching nw_kernel.pack_delbits semantics)
void rt_pack_rows_bits(const uint8_t* blob, const int64_t* starts,
                       const int64_t* ends, int64_t n_rows, int64_t cap,
                       uint8_t* out, int32_t n_threads) {
    const int64_t w = cap / 8;
    rt::parallel_for(n_rows, n_threads, [&](int64_t i, int32_t) {
        uint8_t* dst = out + i * w;
        const uint8_t* src = blob + starts[i];
        int64_t len = ends[i] - starts[i];
        if (len > cap) len = cap;
        const int64_t full = len / 8;
        for (int64_t k = 0; k < full; ++k) {
            uint8_t b = 0;
            for (int u = 0; u < 8; ++u) {
                b |= (src[8 * k + u] != 0) << u;
            }
            dst[k] = b;
        }
        int64_t k = full;
        if (len & 7) {
            uint8_t b = 0;
            for (int64_t u = 0; u < 8; ++u) {
                const int64_t p = 8 * k + u;
                b |= (p >= len || src[p] != 0) << u;
            }
            dst[k] = b;
            ++k;
        }
        if (k < w) std::memset(dst + k, 0xFF, w - k);
    });
}

// threaded ranged gather: dst[dst_off[i] .. +lens[i]) = src[starts[i] ..)
// in elements of `elem` bytes — replaces numpy flat-index-array gathers
// (which materialize a full index vector) in the stage hot loops
void rt_gather_ranges(const uint8_t* src, int64_t elem,
                      const int64_t* starts, const int64_t* lens,
                      const int64_t* dst_off, int64_t n, uint8_t* dst,
                      int32_t n_threads) {
    rt::parallel_for(n, n_threads, [&](int64_t i, int32_t) {
        if (lens[i] > 0) {
            std::memcpy(dst + dst_off[i] * elem, src + starts[i] * elem,
                        lens[i] * elem);
        }
    });
}

// slot composition for the refinement-state replacement (the tail of a
// consensus round): out[dst_off[z] + j] = slots[bb_off[z] +
// min(local[src_off[z] + j], lens[z] - 1)] — replaces a 5-pass numpy
// repeat/fancy-index chain over millions of elements with one threaded pass
void rt_compose_slots(const int64_t* slots, const int64_t* bb_off,
                      const int64_t* lens, const int32_t* local,
                      const int64_t* src_off, const int64_t* new_len,
                      const int64_t* dst_off, int64_t n_windows,
                      int64_t* out, int32_t n_threads) {
    rt::parallel_for(n_windows, n_threads, [&](int64_t z, int32_t) {
        const int64_t* base = slots + bb_off[z];
        const int64_t hi = lens[z] - 1;
        if (hi < 0) return;  // empty backbone: nothing addressable
        const int32_t* lo = local + src_off[z];
        int64_t* dst = out + dst_off[z];
        const int64_t m = new_len[z];
        for (int64_t j = 0; j < m; ++j) {
            int64_t s = lo[j];
            if (s > hi) s = hi;
            if (s < 0) s = 0;
            dst[j] = base[s];
        }
    });
}

// span projection for a round's items: binary-search each item's
// [begin, end] (original coordinates) inside its window's ascending slot
// run — replaces the per-round global keys/searchsorted numpy chain.
// Applies the reference's 1%-of-backbone full-span rule
// (src/window.cpp:87-92) and emits clamped [s0, s1] slot indices.
void rt_project_spans(const int64_t* slots, const int64_t* bb_off,
                      const int64_t* item_wz, const int64_t* begin,
                      const int64_t* end, int64_t n_items, int64_t* out_s0,
                      int64_t* out_s1, int32_t n_threads) {
    rt::parallel_for(n_items, n_threads, [&](int64_t i, int32_t) {
        const int64_t z = item_wz[i];
        const int64_t* lo = slots + bb_off[z];
        const int64_t* hi = slots + bb_off[z + 1];
        const int64_t n = hi - lo;
        if (n <= 0) {  // empty slot run: emit an explicit no-span sentinel
            out_s0[i] = -1;  // (callers only ever pass non-empty windows;
            out_s1[i] = -1;  // fail loudly instead of silently projecting
            return;          // into a neighboring window's slots)
        }
        int64_t b = std::lower_bound(lo, hi, begin[i]) - lo;
        int64_t e = (std::upper_bound(lo, hi, end[i]) - lo) - 1;
        if (b > n - 1) b = n - 1;
        if (b < 0) b = 0;
        if (e > n - 1) e = n - 1;
        if (e < b) e = b;
        const double offset = 0.01 * n;
        if (b < offset && e > n - offset) {
            b = 0;
            e = n - 1;
        }
        out_s0[i] = b;
        out_s1[i] = e;
    });
}

}  // extern "C"

extern "C" {

// breaking points from precomputed op lists (device-aligned overlaps);
// quad_off indexes the output quads, ops_off the input op lists
void rt_breaking_points_from_ops_batch(
    const int32_t* ops_blob, const int64_t* ops_off, const int64_t* ops_count,
    const uint8_t* strand, const int64_t* q_begin, const int64_t* q_end,
    const int64_t* q_length, const int64_t* t_begin, const int64_t* t_end,
    int64_t n, int32_t window_length, int32_t n_threads, int64_t* out_quads,
    const int64_t* quad_off, int64_t* out_counts) {
    rt::parallel_for(n, n_threads, [&](int64_t i, int32_t) {
        const rt::OpRun* ops =
            reinterpret_cast<const rt::OpRun*>(ops_blob) + ops_off[i];
        out_counts[i] = rt::breaking_points(
            ops, ops_count[i], strand[i] != 0, q_begin[i], q_end[i],
            q_length[i], t_begin[i], t_end[i], window_length,
            out_quads + quad_off[i] * 4, quad_off[i + 1] - quad_off[i]);
    });
}

}  // extern "C"

extern "C" {

// phase-profiling readback (RT_POA_PROF=1): build/add_path, heaviest_bundle,
// expansion-emit nanoseconds accumulated across all merge calls
void rt_poa_prof_ns(int64_t* out3) {
    out3[0] = rt::g_prof_build.load();
    out3[1] = rt::g_prof_bundle.load();
    out3[2] = rt::g_prof_emit.load();
}

}  // extern "C"
