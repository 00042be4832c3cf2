// danbing-tk native host runtime (ctypes-loaded shared library).
//
// Provides the handful of host-side operations whose *exact* behavior is
// implementation-defined in the reference toolchain and therefore cannot be
// portably re-derived in Python/numpy:
//
//   dtk_sort_index_by_value : replicates getSortedIndex
//       (reference aQueryFasta_thread.cpp:247-255): std::iota over indices
//       then std::sort with comparator data[i]<data[j].  std::sort is
//       unstable; the tie order (introsort partition behavior) feeds the
//       early-stopped locus-voting scan, so bit-exact .kam/.tr.kmers output
//       requires the real libstdc++ algorithm.
//
//   dtk_reader_*  : streaming FASTA/FASTQ pair reader + 2-bit packer.
//       Replaces the aligner's Python ingest loop: pairs a
//       `samtools fasta -n` stream via a title hashmap (second occurrence
//       first, mirroring the reference reader semantics) and packs bases
//       into fixed (2P, L) u8 batches ready for device upload.  This is
//       the production IO path; Python ingest tops out far below the
//       device's consumption rate.
//
// Everything else in the host engine is pure Python/numpy or JAX.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

void dtk_sort_index_by_value(const uint64_t* data, uint64_t n,
                             uint64_t* indices) {
    std::iota(indices, indices + n, 0);
    std::sort(indices, indices + n,
              [data](uint64_t i1, uint64_t i2) { return data[i1] < data[i2]; });
}

namespace {

struct PendingRead {
    std::string seq;
    std::string qual;  // empty unless fastq
};

struct Reader {
    FILE* f = nullptr;
    bool fastq = false;
    int min_read_size = 0;
    std::unordered_map<std::string, PendingRead> pending;
    // one-record lookahead: properly interleaved PE streams (bam2pe /
    // samtools fasta -n output — the production input) pair every record
    // with its immediate neighbor, so holding the last unpaired record
    // outside the hashmap removes the map traffic from the hot path.
    // Membership semantics are identical: "pending" = map + held slot.
    bool have_held = false;
    std::string held_title;
    PendingRead held;
    // block-buffered line scanning: fgetc-per-char tops out ~20 MB/s
    // (stdio locking per call) and starved the device on WGS-sized
    // streams; a 4 MB read buffer + memchr runs at GB/s.
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;

    Reader() : buf(4 << 20) {}

    bool refill_() {
        if (eof) return false;
        len = fread(buf.data(), 1, buf.size(), f);
        pos = 0;
        if (len == 0) { eof = true; return false; }
        return true;
    }

    bool getline_(std::string& out) {
        out.clear();
        for (;;) {
            if (pos >= len && !refill_()) return !out.empty();
            const char* base = buf.data() + pos;
            size_t avail = len - pos;
            const char* nl = (const char*)memchr(base, '\n', avail);
            if (nl) {
                out.append(base, nl - base);
                pos += (nl - base) + 1;
                return true;
            }
            out.append(base, avail);
            pos = len;
        }
    }
};

const uint8_t kBaseLut[256] = {
    // 255 everywhere except ACGT/acgt
#define X 255
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,0,X,1,X,X,X,2,X,X,X,X,X,X,X,X, X,X,X,X,3,X,X,X,X,X,X,X,X,X,X,X,
    X,0,X,1,X,X,X,2,X,X,X,X,X,X,X,X, X,X,X,X,3,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
    X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X, X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,X,
#undef X
};

void prune_pe(std::string& t) {
    size_t n = t.size();
    if (n >= 2 && t[n - 2] == '/' && (t[n - 1] == '1' || t[n - 1] == '2'))
        t.resize(n - 2);
}

}  // namespace

void* dtk_reader_open(const char* path, int is_fastq, int min_read_size) {
    Reader* r = new Reader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    r->fastq = is_fastq;
    r->min_read_size = min_read_size;
    return r;
}

// Fills codes (2P*L u8, pre-filled 255 by caller), rlen (2P i32), and
// titles_buf (P * title_stride chars, NUL-terminated, '>' stripped).
// quals (2P*L u8, raw ASCII phred+33, 0-padded) may be NULL; it is only
// populated for fastq input (the device bait path needs the quality mask,
// aQueryFasta_thread.h:1038-1078 semantics computed downstream).
// Returns the number of pairs produced (< P at EOF; 0 when exhausted).
int64_t dtk_reader_next_batch_q(void* rp, uint8_t* codes, int32_t* rlen,
                                uint8_t* quals, int64_t P, int64_t L,
                                char* titles_buf, int64_t title_stride) {
    Reader* r = (Reader*)rp;
    int64_t np = 0;
    std::string title, seq, qual, dummy;
    while (np < P) {
        if (!r->getline_(title)) break;
        if (title.empty()) continue;
        if (!r->getline_(seq)) break;
        qual.clear();
        if (r->fastq) {
            r->getline_(dummy);
            r->getline_(qual);
        }
        if (title[0] == '>' || title[0] == '@') title.erase(0, 1);
        prune_pe(title);
        PendingRead mate;
        if (r->have_held && r->held_title == title) {
            mate = std::move(r->held);
            r->have_held = false;
        } else {
            auto it = r->pending.find(title);
            if (it == r->pending.end()) {
                if (r->have_held)
                    r->pending.emplace(std::move(r->held_title),
                                       std::move(r->held));
                r->held_title = std::move(title);
                r->held = PendingRead{std::move(seq), std::move(qual)};
                r->have_held = true;
                continue;
            }
            mate = std::move(it->second);
            r->pending.erase(it);
        }
        if ((int)seq.size() < r->min_read_size ||
            (int)mate.seq.size() < r->min_read_size)
            continue;
        // pack: row 2*np = second occurrence (seq1), row 2*np+1 = stored
        uint8_t* row1 = codes + (2 * np) * L;
        uint8_t* row2 = codes + (2 * np + 1) * L;
        int64_t n1 = std::min<int64_t>(seq.size(), L);
        int64_t n2 = std::min<int64_t>(mate.seq.size(), L);
        for (int64_t i = 0; i < n1; ++i)
            row1[i] = kBaseLut[(uint8_t)seq[i]];
        for (int64_t i = 0; i < n2; ++i)
            row2[i] = kBaseLut[(uint8_t)mate.seq[i]];
        rlen[2 * np] = (int32_t)n1;
        rlen[2 * np + 1] = (int32_t)n2;
        if (quals) {
            memcpy(quals + (2 * np) * L, qual.data(),
                   std::min<int64_t>(qual.size(), L));
            memcpy(quals + (2 * np + 1) * L, mate.qual.data(),
                   std::min<int64_t>(mate.qual.size(), L));
        }
        if (titles_buf) {
            char* t = titles_buf + np * title_stride;
            int64_t tn = std::min<int64_t>(title.size(), title_stride - 1);
            memcpy(t, title.data(), tn);
            t[tn] = '\0';
        }
        ++np;
    }
    return np;
}

int64_t dtk_reader_next_batch(void* rp, uint8_t* codes, int32_t* rlen,
                              int64_t P, int64_t L, char* titles_buf,
                              int64_t title_stride) {
    return dtk_reader_next_batch_q(rp, codes, rlen, nullptr, P, L,
                                   titles_buf, title_stride);
}

// Sampled subfilter queries — native twin of
// ops/kmers_np.sample_subfilter_queries (reference subfilter sampling,
// aQueryFasta_thread.cpp:172-188): the nf evenly-spaced canonical k-mer
// queries per read over a packed (n, L) code batch.  Invalid windows
// (N base, short read, out of range) emit the EMPTY sentinel in both
// u32 halves, matching the device extraction's masking.
void dtk_sample_queries(const uint8_t* codes, const int32_t* rlen,
                        int64_t n, int64_t L, int k, int nf,
                        uint32_t* qlo, uint32_t* qhi, uint8_t* valid,
                        uint8_t* nonshort) {
    const int64_t NKW = L - k + 1;
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* row = codes + r * L;
        int32_t nk = rlen[r] - (k - 1);
        if (nk < 0) nk = 0;
        nonshort[r] = nk > 0;
        int32_t S = (nf > 1) ? nk / (nf - 1) : 0;
        for (int j = 0; j < nf; ++j) {
            int64_t s = (j == nf - 1) ? (int64_t)nk - 1 : (int64_t)j * S;
            if (s < 0) s = 0;
            if (s > NKW - 1) s = NKW - 1;
            uint64_t fwd = 0, rc = 0;
            bool ok = s + k <= rlen[r];
            if (ok)
                for (int t = 0; t < k; ++t) {
                    uint8_t b = row[s + t];
                    if (b > 3) { ok = false; break; }
                    fwd = (fwd << 2) | b;
                    rc |= (uint64_t)(3 - b) << (2 * t);
                }
            bool v = ok && s < nk;
            uint64_t km = fwd < rc ? fwd : rc;
            int64_t o = r * nf + j;
            valid[o] = v;
            qlo[o] = v ? (uint32_t)(km & 0xFFFFFFFFu) : 0xFFFFFFFFu;
            qhi[o] = v ? (uint32_t)(km >> 32) : 0xFFFFFFFFu;
        }
    }
}

void dtk_reader_close(void* rp) {
    Reader* r = (Reader*)rp;
    if (r->f) fclose(r->f);
    delete r;
}

}  // extern "C"
