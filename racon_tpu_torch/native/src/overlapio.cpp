// MHAP/PAF/SAM overlap parsing into columnar arrays; record semantics match
// racon_tpu_torch/io/overlaps_io.py (which mirrors reference src/overlap.cpp
// constructors: MHAP 1-based ids & strand xor, PAF orientation, SAM flag /
// clip / strand-flip accounting).

#include "overlapio.hpp"

#include <zlib.h>

#include "fastx.hpp"

namespace rt {

namespace {

struct Tok {
    const char* p;
    int64_t len;
};

// split a line by delim (tab or any-space); returns token count
static int split(const char* p, const char* eol, bool any_space, Tok* toks,
                 int max_toks) {
    int n = 0;
    const char* s = p;
    while (p <= eol && n < max_toks) {
        const bool at_end = (p == eol);
        const char c = at_end ? '\0' : *p;
        const bool is_delim =
            at_end || (any_space ? (c == ' ' || c == '\t') : c == '\t');
        if (is_delim) {
            if (!any_space || p > s) {  // any_space: skip empty tokens
                toks[n].p = s;
                toks[n].len = p - s;
                if (toks[n].len > 0 && s[toks[n].len - 1] == '\r') {
                    --toks[n].len;
                }
                ++n;
            }
            s = p + 1;
        }
        if (at_end) break;
        ++p;
    }
    return n;
}

static int64_t to_i64(const Tok& t) {
    int64_t v = 0;
    bool neg = false;
    const char* p = t.p;
    const char* e = t.p + t.len;
    if (p < e && (*p == '-' || *p == '+')) {
        neg = (*p == '-');
        ++p;
    }
    for (; p < e && *p >= '0' && *p <= '9'; ++p) v = v * 10 + (*p - '0');
    return neg ? -v : v;
}

static void span_error(int64_t qs, int64_t ts, int64_t& length, double& error) {
    length = qs > ts ? qs : ts;
    const int64_t mn = qs < ts ? qs : ts;
    error = length > 0 ? 1.0 - static_cast<double>(mn) / length : 1.0;
}

}  // namespace

// SAM CIGAR accounting (reference: src/overlap.cpp:55-107)
void sam_cigar_accounting(const char* cig, int64_t cig_len, bool strand,
                          int64_t t_begin, int64_t* q_begin, int64_t* q_end,
                          int64_t* q_length, int64_t* t_end, int64_t* length,
                          double* error) {
    int64_t first_num = 0;
    bool first_found = false;
    int64_t q_aln = 0, q_clip = 0, t_aln = 0;
    int64_t qb = 0;
    int64_t num = 0;
    bool first_op = true;
    for (int64_t i = 0; i < cig_len; ++i) {
        const char c = cig[i];
        if (c >= '0' && c <= '9') {
            num = num * 10 + (c - '0');
            if (!first_found) first_num = first_num * 10 + (c - '0');
            continue;
        }
        first_found = true;
        switch (c) {
            case 'M':
            case '=':
            case 'X':
                q_aln += num;
                t_aln += num;
                break;
            case 'I':
                q_aln += num;
                break;
            case 'D':
            case 'N':
                t_aln += num;
                break;
            case 'S':
            case 'H':
                if (first_op) qb = first_num;
                q_clip += num;
                break;
            default:
                break;  // P and anything else
        }
        first_op = false;
        num = 0;
    }
    int64_t qe = qb + q_aln;
    const int64_t qlen = q_clip + q_aln;
    if (strand) {
        const int64_t tmp = qb;
        qb = qlen - qe;
        qe = qlen - tmp;
    }
    *q_begin = qb;
    *q_end = qe;
    *q_length = qlen;
    *t_end = t_begin + t_aln;
    span_error(q_aln, t_aln, *length, *error);
}

// parse all lines in [p, end) — `end` must sit on a line boundary (or EOF)
static bool parse_overlap_text(const char* p, const char* end, int fmt,
                               const char* path, OverlapResult& res,
                               std::string& err) {
    Tok toks[24];

    while (p < end) {
        const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!eol) eol = end;
        if (eol == p || (eol == p + 1 && *p == '\r')) {
            p = eol < end ? eol + 1 : end;
            continue;
        }
        if (fmt == 2 && *p == '@') {  // SAM header
            p = eol < end ? eol + 1 : end;
            continue;
        }
        const int nt = split(p, eol, fmt == 1, toks, 24);
        if (fmt == 0) {  // PAF
            if (nt < 12) {
                err = std::string("malformed PAF file ") + path;
                return false;
            }
            res.qnames.append(toks[0].p, toks[0].len);
            res.q_length.push_back(to_i64(toks[1]));
            res.q_begin.push_back(to_i64(toks[2]));
            res.q_end.push_back(to_i64(toks[3]));
            res.strand.push_back(toks[4].len == 1 && toks[4].p[0] == '-');
            res.tnames.append(toks[5].p, toks[5].len);
            res.t_length.push_back(to_i64(toks[6]));
            res.t_begin.push_back(to_i64(toks[7]));
            res.t_end.push_back(to_i64(toks[8]));
            res.q_id.push_back(0);
            res.t_id.push_back(0);
            res.is_valid.push_back(1);
            int64_t length;
            double error;
            span_error(res.q_end.back() - res.q_begin.back(),
                       res.t_end.back() - res.t_begin.back(), length, error);
            res.length.push_back(length);
            res.error.push_back(error);
        } else if (fmt == 1) {  // MHAP
            if (nt < 12) {
                err = std::string("malformed MHAP file ") + path;
                return false;
            }
            res.q_id.push_back(to_i64(toks[0]) - 1);
            res.t_id.push_back(to_i64(toks[1]) - 1);
            const int64_t a_rc = to_i64(toks[4]);
            res.q_begin.push_back(to_i64(toks[5]));
            res.q_end.push_back(to_i64(toks[6]));
            res.q_length.push_back(to_i64(toks[7]));
            const int64_t b_rc = to_i64(toks[8]);
            res.t_begin.push_back(to_i64(toks[9]));
            res.t_end.push_back(to_i64(toks[10]));
            res.t_length.push_back(to_i64(toks[11]));
            res.strand.push_back((a_rc ^ b_rc) != 0);
            res.is_valid.push_back(1);
            int64_t length;
            double error;
            span_error(res.q_end.back() - res.q_begin.back(),
                       res.t_end.back() - res.t_begin.back(), length, error);
            res.length.push_back(length);
            res.error.push_back(error);
        } else {  // SAM
            if (nt < 11) {
                err = std::string("malformed SAM file ") + path;
                return false;
            }
            const int64_t flag = to_i64(toks[1]);
            const bool valid = !(flag & 0x4);
            const bool strand = (flag & 0x10) != 0;
            const int64_t t_begin = to_i64(toks[3]) - 1;
            if (toks[5].len < 2 && valid) {
                err = "[Racon::Overlap::Overlap] error: missing alignment "
                      "from SAM object!";
                return false;
            }
            res.qnames.append(toks[0].p, toks[0].len);
            res.tnames.append(toks[2].p, toks[2].len);
            res.cigars.append(toks[5].p, toks[5].len);
            int64_t qb, qe, qlen, te, length;
            double error;
            sam_cigar_accounting(toks[5].p, toks[5].len, strand, t_begin, &qb,
                                 &qe, &qlen, &te, &length, &error);
            res.q_begin.push_back(qb);
            res.q_end.push_back(qe);
            res.q_length.push_back(qlen);
            res.t_begin.push_back(t_begin);
            res.t_end.push_back(te);
            res.t_length.push_back(0);
            res.strand.push_back(strand);
            res.is_valid.push_back(valid ? 1 : 0);
            res.length.push_back(length);
            res.error.push_back(error);
            res.q_id.push_back(0);
            res.t_id.push_back(0);
        }
        res.qname_off.push_back(static_cast<int64_t>(res.qnames.size()));
        res.tname_off.push_back(static_cast<int64_t>(res.tnames.size()));
        res.cigar_off.push_back(static_cast<int64_t>(res.cigars.size()));
        p = eol < end ? eol + 1 : end;
    }
    return true;
}

bool parse_overlaps(const char* path, int fmt, OverlapResult& res,
                    std::string& err) {
    std::string raw;
    if (!read_entire_file(path, raw, err)) return false;
    res.qname_off.push_back(0);
    res.tname_off.push_back(0);
    res.cigar_off.push_back(0);
    return parse_overlap_text(raw.data(), raw.data() + raw.size(), fmt, path,
                              res, err);
}

// ------------------------------------------------------------------ //
// chunked streaming parse (reference: bioparser's parse(dst, max_bytes)
// with racon's kChunkSize = 1 GiB, src/polisher.cpp:26,310-355): bounds
// host memory to one chunk of decompressed text + the surviving records
// ------------------------------------------------------------------ //

OverlapStream* overlap_stream_open(const char* path, int fmt,
                                   std::string& err) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
        err = "unable to open file ";
        err += path;
        return nullptr;
    }
    gzbuffer(f, 1 << 20);
    auto* s = new OverlapStream();
    s->f = f;
    s->fmt = fmt;
    s->path = path;
    return s;
}

// parse ~max_bytes of decompressed text worth of COMPLETE lines into res;
// sets *eof when the file is fully consumed. Returns false on error.
bool overlap_stream_next(OverlapStream* s, int64_t max_bytes,
                         OverlapResult& res, std::string& err, bool* eof) {
    res.qname_off.push_back(0);
    res.tname_off.push_back(0);
    res.cigar_off.push_back(0);
    *eof = false;
    std::string& buf = s->carry;
    size_t want = static_cast<size_t>(max_bytes);
    std::vector<char> tmp(1 << 22);
    while (true) {
        while (!s->at_eof && buf.size() < want) {
            const size_t step = std::min(tmp.size(), want - buf.size());
            int n = gzread(static_cast<gzFile>(s->f), tmp.data(),
                           static_cast<unsigned>(step));
            if (n < 0) {
                err = std::string("error while reading ") + s->path;
                return false;
            }
            if (n == 0) {
                s->at_eof = true;
                break;
            }
            buf.append(tmp.data(), n);
        }
        size_t cut = buf.size();
        if (!s->at_eof) {  // stop at the last complete line
            const size_t nl = buf.rfind('\n');
            if (nl == std::string::npos) {
                want *= 2;  // one line exceeds the chunk budget: grow
                continue;
            }
            cut = nl + 1;
        }
        if (!parse_overlap_text(buf.data(), buf.data() + cut, s->fmt,
                                s->path.c_str(), res, err)) {
            return false;
        }
        buf.erase(0, cut);
        *eof = s->at_eof && buf.empty();
        return true;
    }
}

void overlap_stream_free(OverlapStream* s) {
    if (s) {
        if (s->f) gzclose(static_cast<gzFile>(s->f));
        delete s;
    }
}

}  // namespace rt
