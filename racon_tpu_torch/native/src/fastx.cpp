// FASTA/FASTQ ingestion (plain or gzip, via zlib) into columnar blobs.
// Plays the reference's bioparser role (SURVEY.md sec 2.2) for sequence
// files; record semantics match racon_tpu_torch/io/fastx.py:
//   name = header token up to first whitespace; bases uppercased;
//   all-'!' quality strings dropped (phred sum zero).

#include "fastx.hpp"

#include <zlib.h>

#include <cctype>

namespace rt {

bool read_entire_file(const char* path, std::string& out, std::string& err) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
        err = "unable to open file ";
        err += path;
        return false;
    }
    gzbuffer(f, 1 << 20);
    out.clear();
    std::vector<char> buf(1 << 22);
    int n;
    while ((n = gzread(f, buf.data(), static_cast<unsigned>(buf.size()))) > 0) {
        out.append(buf.data(), n);
    }
    bool ok = (n == 0);
    if (!ok) err = std::string("error while reading ") + path;
    gzclose(f);
    return ok;
}

static inline const char* name_end(const char* p, const char* eol) {
    while (p < eol && *p != ' ' && *p != '\t' && *p != '\r') ++p;
    return p;
}

static inline void append_upper(std::string& dst, const char* p, const char* e) {
    for (; p < e; ++p) {
        char c = *p;
        if (c == '\r') continue;
        dst += static_cast<char>(toupper(static_cast<unsigned char>(c)));
    }
}

// parse complete records in [p, end); with eof=false a record cut off at
// `end` is rolled back and *consumed points at its start (the caller
// carries the tail into the next chunk)
static bool parse_fasta_text(const char* p, const char* end, bool eof,
                             const char* path, FastxResult& res,
                             std::string& err, const char** consumed) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p < end && *p != '>') {
        err = std::string("malformed FASTA file ") + path;
        return false;
    }
    while (p < end) {
        // at '>'
        const char* rec_start = p;
        const size_t names_sz = res.names.size();
        const size_t data_sz = res.data.size();
        const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!eol) eol = end;
        const char* ne = name_end(p + 1, eol);
        res.names.append(p + 1, ne - (p + 1));
        p = eol < end ? eol + 1 : end;
        while (p < end && *p != '>') {
            const char* l_eol = static_cast<const char*>(
                memchr(p, '\n', end - p));
            if (!l_eol) l_eol = end;
            append_upper(res.data, p, l_eol);
            p = l_eol < end ? l_eol + 1 : end;
        }
        if (p == end && !eof) {  // record may continue in the next chunk
            res.names.resize(names_sz);
            res.data.resize(data_sz);
            *consumed = rec_start;
            return true;
        }
        res.name_off.push_back(static_cast<int64_t>(res.names.size()));
        res.data_off.push_back(static_cast<int64_t>(res.data.size()));
        res.qual_off.push_back(static_cast<int64_t>(res.quals.size()));
    }
    *consumed = end;
    return true;
}

static bool parse_fastq_text(const char* p, const char* end, bool eof,
                             const char* path, FastxResult& res,
                             std::string& err, const char** consumed) {
    while (p < end) {
        while (p < end && (*p == '\n' || *p == '\r')) ++p;
        if (p >= end) break;
        const char* rec_start = p;
        const size_t names_sz = res.names.size();
        const size_t data_sz = res.data.size();
        if (*p != '@') {
            err = std::string("malformed FASTQ file ") + path;
            return false;
        }
        const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!eol) eol = end;
        const char* ne = name_end(p + 1, eol);
        res.names.append(p + 1, ne - (p + 1));
        p = eol < end ? eol + 1 : end;
        const size_t data_start = res.data.size();
        while (p < end && *p != '+') {
            const char* l_eol = static_cast<const char*>(
                memchr(p, '\n', end - p));
            if (!l_eol) l_eol = end;
            append_upper(res.data, p, l_eol);
            p = l_eol < end ? l_eol + 1 : end;
        }
        // skip '+' line
        if (p < end) {
            const char* l_eol = static_cast<const char*>(
                memchr(p, '\n', end - p));
            p = l_eol ? l_eol + 1 : end;
        }
        const size_t dlen = res.data.size() - data_start;
        std::string q;
        q.reserve(dlen);
        while (p < end && q.size() < dlen) {
            const char* l_eol = static_cast<const char*>(
                memchr(p, '\n', end - p));
            if (!l_eol) l_eol = end;
            for (const char* c = p; c < l_eol; ++c) {
                if (*c != '\r') q += *c;
            }
            p = l_eol < end ? l_eol + 1 : end;
        }
        if (!eof && p == end) {
            // any record touching the chunk end may continue in the next
            // chunk (e.g. the cut fell right after the header, so dlen==0
            // "completes" vacuously): roll back and carry unconditionally
            res.names.resize(names_sz);
            res.data.resize(data_sz);
            *consumed = rec_start;
            return true;
        }
        if (q.size() != dlen) {
            err = std::string("malformed FASTQ file ") + path;
            return false;
        }
        // drop all-'!' qualities
        bool nonzero = false;
        for (char c : q) {
            if (c != '!') {
                nonzero = true;
                break;
            }
        }
        if (nonzero) res.quals += q;
        res.name_off.push_back(static_cast<int64_t>(res.names.size()));
        res.data_off.push_back(static_cast<int64_t>(res.data.size()));
        res.qual_off.push_back(static_cast<int64_t>(res.quals.size()));
    }
    *consumed = end;
    return true;
}

bool parse_fastx(const char* path, bool is_fastq, FastxResult& res,
                 std::string& err) {
    std::string raw;
    if (!read_entire_file(path, raw, err)) return false;
    res.name_off.push_back(0);
    res.data_off.push_back(0);
    res.qual_off.push_back(0);
    const char* consumed = nullptr;
    if (is_fastq) {
        return parse_fastq_text(raw.data(), raw.data() + raw.size(), true,
                                path, res, err, &consumed);
    }
    return parse_fasta_text(raw.data(), raw.data() + raw.size(), true, path,
                            res, err, &consumed);
}

// ------------------------------------------------------------------ //
// chunked streaming parse (bioparser parse(dst, max_bytes) role for
// sequence files, reference src/polisher.cpp:229-264): transient memory is
// one chunk of decompressed text, not the whole file
// ------------------------------------------------------------------ //

FastxStream* fastx_stream_open(const char* path, bool is_fastq,
                               std::string& err) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
        err = "unable to open file ";
        err += path;
        return nullptr;
    }
    gzbuffer(f, 1 << 20);
    auto* s = new FastxStream();
    s->f = f;
    s->is_fastq = is_fastq;
    s->path = path;
    return s;
}

bool fastx_stream_next(FastxStream* s, int64_t max_bytes, FastxResult& res,
                       std::string& err, bool* eof) {
    res.name_off.push_back(0);
    res.data_off.push_back(0);
    res.qual_off.push_back(0);
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
        const char* consumed = nullptr;
        const bool ok = s->is_fastq
                            ? parse_fastq_text(buf.data(),
                                               buf.data() + buf.size(),
                                               s->at_eof, s->path.c_str(),
                                               res, err, &consumed)
                            : parse_fasta_text(buf.data(),
                                               buf.data() + buf.size(),
                                               s->at_eof, s->path.c_str(),
                                               res, err, &consumed);
        if (!ok) return false;
        if (!s->at_eof && res.size() == 0 && !buf.empty()) {
            want *= 2;  // a single record exceeds the chunk budget: grow
            continue;
        }
        buf.erase(0, consumed - buf.data());
        *eof = s->at_eof && buf.empty();
        return true;
    }
}

void fastx_stream_free(FastxStream* s) {
    if (s) {
        if (s->f) gzclose(static_cast<gzFile>(s->f));
        delete s;
    }
}

}  // namespace rt
