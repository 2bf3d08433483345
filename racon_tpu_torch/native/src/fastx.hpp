#pragma once

#include "common.hpp"

namespace rt {

struct FastxResult {
    std::string names, data, quals;
    std::vector<int64_t> name_off, data_off, qual_off;  // n+1 each
    int64_t size() const {
        return static_cast<int64_t>(name_off.size()) - 1;
    }
};

bool read_entire_file(const char* path, std::string& out, std::string& err);
bool parse_fastx(const char* path, bool is_fastq, FastxResult& res,
                 std::string& err);

// chunked streaming parse (bioparser parse(dst, max_bytes) equivalent)
struct FastxStream {
    void* f = nullptr;  // gzFile
    bool is_fastq = false;
    std::string path;
    std::string carry;
    bool at_eof = false;
};

FastxStream* fastx_stream_open(const char* path, bool is_fastq,
                               std::string& err);
bool fastx_stream_next(FastxStream* s, int64_t max_bytes, FastxResult& res,
                       std::string& err, bool* eof);
void fastx_stream_free(FastxStream* s);

}  // namespace rt
