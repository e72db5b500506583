// Native FASTA -> base-code batch loader.
//
// The reference's data-loading layer is C++ (line-accumulating FASTA
// readers in /root/reference/swig/writeBloom_rolling.cpp:22-60 and
// Tests/AdHoc/ParallelFilter.cpp:109-122). This is its TPU-framework
// equivalent: it parses FASTA straight into the N-padded uint8 code
// batches the hasher consumes ([batch, pad] arrays; reads longer than
// `pad` split into chunks overlapping by k-1 so every k-mer window of the
// original read appears in exactly one chunk), so the host-side Python
// loop never touches per-base data.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

struct Encoder {
    uint8_t table[256];
    Encoder() {
        memset(table, 4, sizeof(table));  // N code
        const char* bases = "ACGT";
        for (int i = 0; i < 4; ++i) {
            table[(unsigned char)bases[i]] = (uint8_t)i;
            table[(unsigned char)(bases[i] + 32)] = (uint8_t)i;
        }
        table[(unsigned char)'U'] = 3;  // 'U' behaves like 'T' (seedTab)
        table[(unsigned char)'u'] = 3;
    }
};
const Encoder kEncoder;

struct Reader {
    FILE* f = nullptr;
    std::string carry;     // current record's not-yet-fully-chunked bases
    size_t off = 0;        // start of the next chunk within carry
    bool done = false;
    bool flush_pending = false;  // record ended; tail must be emitted
    std::string line;

    bool next_line() {
        line.clear();
        int c;
        while ((c = fgetc(f)) != EOF) {
            if (c == '\n') return true;
            if (c != '\r') line.push_back((char)c);
        }
        done = true;
        return !line.empty();
    }
};

}  // namespace

extern "C" {

void* fasta_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    setvbuf(f, nullptr, _IOFBF, 1 << 20);
    Reader* r = new Reader();
    r->f = f;
    return r;
}

void fasta_close(void* handle) {
    Reader* r = (Reader*)handle;
    if (r) {
        if (r->f) fclose(r->f);
        delete r;
    }
}

// Fill up to `batch` rows of `pad` codes each (N-padded, code 4).
// Returns rows filled; 0 => end of input; -1 => bad arguments.
int64_t fasta_next_batch(void* handle, uint8_t* out, int64_t batch,
                         int64_t pad, int64_t k) {
    Reader* r = (Reader*)handle;
    if (!r || pad < k || k < 1) return -1;
    const size_t step = (size_t)(pad - (k - 1));
    int64_t row = 0;
    memset(out, 4, (size_t)(batch * pad));

    auto avail = [&]() { return r->carry.size() - r->off; };
    auto emit = [&](size_t len) {
        const char* src = r->carry.data() + r->off;
        uint8_t* dst = out + row * pad;
        for (size_t i = 0; i < len; ++i)
            dst[i] = kEncoder.table[(unsigned char)src[i]];
        ++row;
    };

    while (row < batch) {
        // full-width chunks: only emit once a whole `pad` window is known
        // (a record may arrive over many short lines)
        while (row < batch && avail() >= (size_t)pad) {
            emit((size_t)pad);
            r->off += step;
            if (r->off > (size_t)(8 * pad)) {  // bound memory, giant records
                r->carry.erase(0, r->off);
                r->off = 0;
            }
        }
        if (row >= batch) break;
        if (r->flush_pending) {
            // record ended: flush the tail (< pad) if it holds a window
            if (avail() >= (size_t)k) emit(avail());
            r->carry.clear();
            r->off = 0;
            r->flush_pending = false;
            if (r->done) break;
            continue;
        }
        if (r->done) break;
        if (!r->next_line()) {
            r->flush_pending = true;  // EOF flush
            continue;
        }
        if (!r->line.empty() && r->line[0] == '>') {
            r->flush_pending = true;  // flush previous record before moving on
        } else if (!r->line.empty()) {
            r->carry += r->line;
        }
        if (r->done) r->flush_pending = true;
    }
    return row;
}

// Encode a raw ASCII buffer to base codes (for in-memory sequences).
void encode_ascii(const char* seq, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = kEncoder.table[(unsigned char)seq[i]];
}

}  // extern "C"
