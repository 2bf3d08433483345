#pragma once

#include "common.hpp"

namespace rt {

struct OverlapResult {
    std::string qnames, tnames, cigars;
    std::vector<int64_t> qname_off, tname_off, cigar_off;  // n+1
    std::vector<int64_t> q_id, t_id, q_begin, q_end, q_length;
    std::vector<int64_t> t_begin, t_end, t_length, length;
    std::vector<uint8_t> strand, is_valid;
    std::vector<double> error;
    int64_t size() const {
        return static_cast<int64_t>(qname_off.size()) - 1;
    }
};

void sam_cigar_accounting(const char* cig, int64_t cig_len, bool strand,
                          int64_t t_begin, int64_t* q_begin, int64_t* q_end,
                          int64_t* q_length, int64_t* t_end, int64_t* length,
                          double* error);

// fmt: 0 = PAF, 1 = MHAP, 2 = SAM
bool parse_overlaps(const char* path, int fmt, OverlapResult& res,
                    std::string& err);

// chunked streaming parse (bioparser parse(dst, max_bytes) equivalent)
struct OverlapStream {
    void* f = nullptr;  // gzFile
    int fmt = 0;
    std::string path;
    std::string carry;
    bool at_eof = false;
};

OverlapStream* overlap_stream_open(const char* path, int fmt,
                                   std::string& err);
bool overlap_stream_next(OverlapStream* s, int64_t max_bytes,
                         OverlapResult& res, std::string& err, bool* eof);
void overlap_stream_free(OverlapStream* s);

}  // namespace rt
