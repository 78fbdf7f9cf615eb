// Copied from hypo_tpu/native/host_native.cpp; FastxReader::next_line
// finds newlines with memchr.
// Native host runtime for hypo_tpu: the OpenMP-parallel per-alignment
// stages that the reference runs as C++ loops (reference
// src/Alignment.cpp:65-220 support updates, external/suk k-mer counting).
//
// All entry points use a flat C ABI for ctypes.  Semantics mirror the
// Python/NumPy implementations in hypo_tpu/segment/support.py and
// hypo_tpu/kmers/counting.py bit-for-bit (tested for parity); those stay
// as the executable oracle and fallback.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -fopenmp -march=native
#include <algorithm>
#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// Read-code buffers are 2-BIT PACKED (4 bases/byte, base i at bits
// (i&3)*2 of byte i>>2 — the PackedSeq<2> role, reference
// include/PackedSeq.hpp:80-160).  Offsets stay in BASES.  Scan loops
// unpack each alignment once into a thread-local scratch: one extra
// pass per read, 4x less resident memory for the batch store.
static inline void unpack2_into(const uint8_t* packed, int64_t base0,
                                int64_t len, std::vector<uint8_t>& out) {
    out.resize((size_t)len);
    for (int64_t i = 0; i < len; ++i) {
        const int64_t b = base0 + i;
        out[(size_t)i] = (packed[b >> 2] >> ((b & 3) << 1)) & 3;
    }
}

extern "C" {

// ---------------------------------------------------------------------
// Canonical k-mer counting (dense table).
//
// codes: concatenated read codes (0..3 = ACGT, >=4 resets the window,
// used as the read separator).  table: 4^k uint32 slots, incremented
// (saturating at 0xFFFFFFFF) for the canonical (min of fwd/rc packing)
// of every N-free k-mer window.
void hypo_count_kmers_dense(const uint8_t* codes, int64_t n, int k,
                            uint32_t* table, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const int shift = 2 * (k - 1);
    // Radix-buffered increments: at k=13 the 4^k u32 table is 256 MB
    // and a direct atomic per kmer is one cache/TLB miss each — on
    // virtualized memory that measured 10-30M increments/s for a
    // 3 Gbp read set.  Buffering canonical kmers by their top bits and
    // applying each bucket in one burst keeps every burst inside a
    // <=1 MB table slice.
    const int pbits = std::max(0, 2 * k - 18);
    const int nparts = 1 << pbits;
    const int psh = 2 * k - pbits;          // canon >> psh = partition
    constexpr int BUF = 8192;
    // chunk with (k-1) overlap so each thread rebuilds its rolling state
#pragma omp parallel
    {
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
        const int nth = omp_get_num_threads();
#else
        const int tid = 0, nth = 1;
#endif
        std::vector<uint32_t> bufs((size_t)nparts * BUF);
        std::vector<int> fill(nparts, 0);
        auto apply = [&](int p) {
            const uint64_t base = (uint64_t)p << psh;
            uint32_t* b = &bufs[(size_t)p * BUF];
            const int f = fill[p];
            for (int x = 0; x < f; ++x) {
                auto* slot = reinterpret_cast<std::atomic<uint32_t>*>(
                    &table[base + b[x]]);
                uint32_t cur = slot->load(std::memory_order_relaxed);
                while (cur != 0xFFFFFFFFu &&
                       !slot->compare_exchange_weak(
                           cur, cur + 1, std::memory_order_relaxed)) {}
            }
            fill[p] = 0;
        };
        const int64_t chunk = (n + nth - 1) / nth;
        const int64_t beg = tid * chunk;
        const int64_t end = std::min(n, beg + chunk);
        if (beg < end) {
            // start the scan k-1 bases early to warm the rolling window;
            // only record kmers whose START is in [beg, end)
            int64_t scan0 = std::max<int64_t>(0, beg - (k - 1));
            uint64_t fwd = 0, rc = 0;
            int valid = 0;
            for (int64_t i = scan0; i < std::min(n, end + k - 1); ++i) {
                uint8_t c = codes[i];
                if (c < 4) {
                    fwd = ((fwd << 2) | c) & mask;
                    rc = (rc >> 2) | ((uint64_t)(3 ^ c) << shift);
                    ++valid;
                    if (valid >= k) {
                        int64_t start = i - k + 1;
                        if (start >= beg && start < end) {
                            const uint64_t canon = fwd < rc ? fwd : rc;
                            const int p = (int)(canon >> psh);
                            bufs[(size_t)p * BUF + fill[p]++] =
                                (uint32_t)(canon & ((1ULL << psh) - 1));
                            if (fill[p] == BUF) apply(p);
                        }
                    }
                } else {
                    valid = 0;
                }
            }
            for (int p = 0; p < nparts; ++p) apply(p);
        }
    }
}

// ---------------------------------------------------------------------
// Canonical k-mer counting (sparse, radix-partitioned) — the k >= 15
// path where the 4^k dense table no longer fits.  This is the KMC3
// role (reference external/suk/src/SolidKmers.cpp:104-151) as an
// in-process accumulator: canonical kmers are bucketed by their top
// bits into NPART partitions; each partition keeps a sorted
// (code, count) store that pending batches are sort-merged into.
// Memory stays bounded by (distinct kmers + pending batch).
//
// Lifecycle: new -> add* -> finalize -> items -> free.  items() emits
// partitions in order, so the full (codes, counts) output is globally
// sorted ascending — identical to the NumPy oracle in
// hypo_tpu/kmers/counting.py (tested for parity).

struct HypoSparseCounter {
    int k;
    int pbits;
    int64_t pending_limit;
    int64_t pending_total = 0;
    // per-partition list of pending batches (moved in whole from the
    // scan threads — no copies on the hot path)
    std::vector<std::vector<std::vector<uint64_t>>> pending;
    std::vector<std::vector<uint64_t>> codes;    // sorted distinct
    std::vector<std::vector<uint32_t>> counts;
};

static void sparse_compact_part(HypoSparseCounter* h, int p) {
    auto& batches = h->pending[p];
    if (batches.empty()) return;
    size_t tot = 0;
    for (auto& b : batches) tot += b.size();
    if (tot == 0) { batches.clear(); return; }
    std::vector<uint64_t> pend;
    pend.reserve(tot);
    for (auto& b : batches)
        pend.insert(pend.end(), b.begin(), b.end());
    batches.clear();
    batches.shrink_to_fit();
    std::sort(pend.begin(), pend.end());
    auto& oc = h->codes[p];
    auto& on = h->counts[p];
    std::vector<uint64_t> nc;
    std::vector<uint32_t> nn;
    nc.reserve(oc.size() + pend.size());
    nn.reserve(oc.size() + pend.size());
    size_t i = 0, j = 0;
    while (i < oc.size() || j < pend.size()) {
        if (j >= pend.size() || (i < oc.size() && oc[i] < pend[j])) {
            nc.push_back(oc[i]);
            nn.push_back(on[i]);
            ++i;
        } else {
            uint64_t v = pend[j];
            uint64_t run = 0;
            while (j < pend.size() && pend[j] == v) { ++run; ++j; }
            if (i < oc.size() && oc[i] == v) {
                run += on[i];
                ++i;
            }
            nc.push_back(v);
            nn.push_back((uint32_t)std::min<uint64_t>(run, 0xFFFFFFFFu));
        }
    }
    oc.swap(nc);
    on.swap(nn);
}

static void sparse_compact_all(HypoSparseCounter* h, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    const int np = 1 << h->pbits;
#pragma omp parallel for schedule(dynamic, 1)
    for (int p = 0; p < np; ++p) sparse_compact_part(h, p);
    h->pending_total = 0;
}

void* hypo_sparse_counter_new(int k, int pbits, int64_t pending_limit) {
    auto* h = new HypoSparseCounter();
    h->k = k;
    h->pbits = pbits;
    h->pending_limit = pending_limit > 0 ? pending_limit : (192LL << 20);
    const int np = 1 << pbits;
    h->pending.resize(np);
    h->codes.resize(np);
    h->counts.resize(np);
    return h;
}

void hypo_sparse_counter_add(void* hv, const uint8_t* seq_codes,
                             int64_t n, int nthreads) {
    auto* h = reinterpret_cast<HypoSparseCounter*>(hv);
    const int k = h->k;
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const int shift = 2 * (k - 1);
    const int pshift = 2 * k - h->pbits;
    const int np = 1 << h->pbits;
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
#pragma omp parallel
    {
        // thread-local partition buffers, MOVED into the store under a
        // critical section at the end (pointer swaps, not copies)
        std::vector<std::vector<uint64_t>> loc(np);
#ifdef _OPENMP
        const int tid = omp_get_thread_num();
        const int nth = omp_get_num_threads();
#else
        const int tid = 0, nth = 1;
#endif
        const int64_t chunk = (n + nth - 1) / nth;
        const int64_t beg = tid * chunk;
        const int64_t end = std::min(n, beg + chunk);
        if (beg < end) {
            const size_t est = (size_t)(end - beg) / np + 64;
            for (auto& v : loc) v.reserve(est + est / 4);
            int64_t scan0 = std::max<int64_t>(0, beg - (k - 1));
            uint64_t fwd = 0, rc = 0;
            int valid = 0;
            for (int64_t i = scan0; i < std::min(n, end + k - 1); ++i) {
                uint8_t c = seq_codes[i];
                if (c < 4) {
                    fwd = ((fwd << 2) | c) & mask;
                    rc = (rc >> 2) | ((uint64_t)(3 ^ c) << shift);
                    ++valid;
                    if (valid >= k) {
                        int64_t start = i - k + 1;
                        if (start >= beg && start < end) {
                            uint64_t canon = fwd < rc ? fwd : rc;
                            loc[canon >> pshift].push_back(canon);
                        }
                    }
                } else {
                    valid = 0;
                }
            }
        }
#pragma omp critical
        {
            for (int p = 0; p < np; ++p) {
                if (loc[p].empty()) continue;
                h->pending_total += (int64_t)loc[p].size();
                h->pending[p].push_back(std::move(loc[p]));
            }
        }
    }
    if (h->pending_total > h->pending_limit)
        sparse_compact_all(h, nthreads);
}

int64_t hypo_sparse_counter_finalize(void* hv, int nthreads) {
    auto* h = reinterpret_cast<HypoSparseCounter*>(hv);
    sparse_compact_all(h, nthreads);
    int64_t total = 0;
    for (auto& c : h->codes) total += (int64_t)c.size();
    return total;
}

void hypo_sparse_counter_items(void* hv, int64_t* codes_out,
                               uint32_t* counts_out) {
    auto* h = reinterpret_cast<HypoSparseCounter*>(hv);
    int64_t off = 0;
    const int np = 1 << h->pbits;
    for (int p = 0; p < np; ++p) {
        const auto& c = h->codes[p];
        const auto& n = h->counts[p];
        std::memcpy(codes_out + off, c.data(),
                    c.size() * sizeof(uint64_t));
        std::memcpy(counts_out + off, n.data(),
                    n.size() * sizeof(uint32_t));
        off += (int64_t)c.size();
    }
}

void hypo_sparse_counter_free(void* hv) {
    delete reinterpret_cast<HypoSparseCounter*>(hv);
}

// ---------------------------------------------------------------------
// Solid-kmer coverage/support update (reference
// Alignment::update_solidkmers_support, src/Alignment.cpp:65-132).
//
// positions/kids: per-contig solid k-mer start positions (sorted) and
// their packed values.  Alignments arrive as a concatenated code buffer
// plus offsets and rb/re arrays.  Outputs: cov_diff (length npos+1,
// caller integrates with cumsum) and support (length npos), both
// accumulated atomically.
void hypo_skmer_support(const int64_t* positions, const int64_t* kids,
                        int64_t npos, int k,
                        const uint8_t* codes, const int64_t* code_off,
                        const int64_t* rb, const int64_t* re,
                        int64_t n_aln,
                        int64_t* cov_diff, int64_t* support,
                        int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
#pragma omp parallel
    {
        std::vector<std::pair<uint64_t, int32_t>> rk;    // (kmer, read pos)
        std::vector<std::array<int64_t, 3>> trip;        // (j, c, sp)
        std::vector<uint8_t> qbuf;
#pragma omp for schedule(dynamic, 64)
        for (int64_t a = 0; a < n_aln; ++a) {
            const int64_t arb = rb[a], are = re[a];
            const int64_t first =
                std::lower_bound(positions, positions + npos, arb) -
                positions;
            const int64_t last0 =
                std::lower_bound(positions, positions + npos, are) -
                positions;
            const int64_t fit =
                std::upper_bound(positions, positions + npos, are - k) -
                positions;
            const int64_t last = fit > first ? fit : last0;
            if (last <= first) continue;
#pragma omp atomic
            cov_diff[first] += 1;
#pragma omp atomic
            cov_diff[last] -= 1;

            const int64_t qlen = code_off[a + 1] - code_off[a];
            if (qlen < k) continue;
            unpack2_into(codes, code_off[a], qlen, qbuf);
            const uint8_t* q = qbuf.data();
            rk.clear();
            uint64_t fwd = 0;
            for (int64_t j = 0; j < qlen; ++j) {
                fwd = ((fwd << 2) | q[j]) & mask;
                if (j >= k - 1) rk.emplace_back(fwd, (int32_t)(j - k + 1));
            }
            std::sort(rk.begin(), rk.end());

            trip.clear();
            const int64_t num_cbases = are - arb;
            for (int64_t c = first; c < last; ++c) {
                const uint64_t kid = (uint64_t)kids[c];
                auto lo = std::lower_bound(
                    rk.begin(), rk.end(),
                    std::make_pair(kid, (int32_t)INT32_MIN));
                const int64_t c_dist = positions[c] - arb;
                const int64_t left = std::max<int64_t>(c_dist - k, 0);
                const int64_t right =
                    std::min<int64_t>(num_cbases, c_dist + k);
                for (; lo != rk.end() && lo->first == kid; ++lo) {
                    const int64_t j = lo->second;
                    if (j >= left && j <= right)
                        trip.push_back({j, c, positions[c]});
                }
            }
            if (trip.empty()) continue;
            std::sort(trip.begin(), trip.end());
            // sequential adjacent-kmer insertion heuristic
            // (reference Alignment.cpp:116-127)
            int64_t pvs_kpos = -1, pvs_rbind = 0;
            for (const auto& t : trip) {
                const int64_t j = t[0], c = t[1], sp = t[2];
                bool should = true;
                if (pvs_kpos > -1 && sp <= k + pvs_kpos)
                    if ((j - pvs_rbind) != (sp - pvs_kpos)) should = false;
                if (should) {
                    pvs_kpos = sp;
                    pvs_rbind = j;
#pragma omp atomic
                    support[c] += 1;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------
// FASTA/FASTQ (.gz) -> code stream (the kseq role, reference
// include/kseq.h): parses reads and emits uint8 codes 0..3 with a `4`
// separator after every read, pulled in caller-sized chunks.  Exists
// because yielding 30M+ python strings per 100 Mbp read set costs
// minutes; this streams codes straight into the k-mer counters.
#include <zlib.h>

namespace {

struct FastxReader {
    gzFile gz = nullptr;
    std::vector<char> buf;      // raw line buffer
    size_t lo = 0, hi = 0;      // window into buf
    bool fasta = false;
    bool started = false;
    int state = 0;   // 0 expect-header, 1 seq, 2 plus, 3 qual
    bool eof = false;

    bool refill() {
        if (lo > 0) {
            std::memmove(buf.data(), buf.data() + lo, hi - lo);
            hi -= lo;
            lo = 0;
        }
        if (buf.size() - hi < (1 << 16)) buf.resize(buf.size() + (1 << 20));
        int n = gzread(gz, buf.data() + hi,
                       (unsigned)(buf.size() - hi));
        if (n <= 0) return false;
        hi += (size_t)n;
        return true;
    }

    // returns [p0, p1) of the next line (without newline), or false.
    // memchr finds the newline; after a refill (which moves the line's
    // start to 0) only the new bytes are searched.
    bool next_line(size_t& p0, size_t& p1) {
        size_t from = lo;
        while (true) {
            const char* nl = static_cast<const char*>(
                std::memchr(buf.data() + from, '\n', hi - from));
            if (nl) {
                p0 = lo;
                p1 = (size_t)(nl - buf.data());
                lo = p1 + 1;
                return true;
            }
            from = hi - lo;
            if (!refill()) {
                if (hi > lo) { p0 = lo; p1 = hi; lo = hi; return true; }
                return false;
            }
        }
    }
};

struct AsciiInit {
    uint8_t t[256];
    AsciiInit() {
        for (int i = 0; i < 256; ++i) t[i] = 4;
        t['A'] = t['a'] = 0; t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2; t['T'] = t['t'] = 3;
        t['U'] = t['u'] = 3;
    }
};
const AsciiInit kA2C;

}  // namespace

void* hypo_fastx_open(const char* path) {
    auto* r = new FastxReader();
    r->gz = gzopen(path, "rb");
    if (!r->gz) { delete r; return nullptr; }
    gzbuffer(r->gz, 1 << 20);
    r->buf.resize(1 << 20);
    return r;
}

// Fill out[0..cap) with read codes + `4` separators; returns the
// number of codes written (0 = EOF).  A read is never split across
// calls EXCEPT its trailing separator; cap must exceed the longest
// read (FASTA contig streaming should use io.fasta instead).
int64_t hypo_fastx_codes(void* h, uint8_t* out, int64_t cap) {
    auto* r = (FastxReader*)h;
    int64_t n = 0;
    size_t p0, p1;
    while (true) {
        if (!r->started) {
            if (!r->next_line(p0, p1)) return n;
            r->started = true;
            r->fasta = (p0 < p1 && r->buf[p0] == '>');
            r->state = 1;
            continue;
        }
        if (r->fasta) {
            if (!r->next_line(p0, p1)) {
                if (r->state == 1 && n < cap) out[n++] = 4;
                r->state = 0;
                return n;
            }
            if (p0 < p1 && r->buf[p0] == '>') {
                if (n < cap) out[n++] = 4;      // end previous read
                if (n + (1 << 16) > cap) return n;
                continue;
            }
            if (n + (int64_t)(p1 - p0) + 1 > cap) {
                // put the line back and return what we have
                r->lo = p0;
                return n;
            }
            for (size_t i = p0; i < p1; ++i)
                out[n++] = kA2C.t[(uint8_t)r->buf[i]];
        } else {
            // FASTQ: header already consumed (state machine)
            if (!r->next_line(p0, p1)) return n;     // seq line
            if (n + (int64_t)(p1 - p0) + 1 > cap) {
                r->lo = p0;
                return n;
            }
            for (size_t i = p0; i < p1; ++i)
                out[n++] = kA2C.t[(uint8_t)r->buf[i]];
            out[n++] = 4;
            if (!r->next_line(p0, p1)) return n;     // '+'
            if (!r->next_line(p0, p1)) return n;     // qual
            if (!r->next_line(p0, p1)) return n;     // next header
        }
    }
}

void hypo_fastx_close(void* h) {
    auto* r = (FastxReader*)h;
    if (r->gz) gzclose(r->gz);
    delete r;
}

// ---------------------------------------------------------------------
// Solid-position scan (reference Contig::find_solid_pos,
// src/Contig.cpp:40-74): rolling k-mer over the draft, solid-bitset
// membership, homopolymer-terminal exclusion.  One sequential pass over
// the byte codes — the numpy path materializes several 8x-larger int64
// temporaries, which on virtualized memory dominates the stage.
namespace {
struct SolidPos {
    std::vector<int64_t> pos;
    std::vector<int64_t> kid;
};
}  // namespace

void* hypo_find_solid_pos(const uint8_t* codes, int64_t n, int k,
                          const uint64_t* words, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#else
    (void)nthreads;
#endif
    auto* R = new SolidPos();
    if (n < k) return R;
    const int64_t m = n - k + 1;
    const uint64_t mask =
        (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
    const int nchunks =
#ifdef _OPENMP
        std::max(1, std::min((int)((m + (1 << 20) - 1) >> 20),
                             omp_get_max_threads()));
#else
        1;
#endif
    std::vector<std::vector<int64_t>> ppos(nchunks), pkid(nchunks);
#pragma omp parallel for schedule(static)
    for (int c = 0; c < nchunks; ++c) {
        const int64_t s0 = m * c / nchunks, s1 = m * (c + 1) / nchunks;
        auto& vp = ppos[c];
        auto& vk = pkid[c];
        uint64_t fwd = 0;
        int64_t run = 0;            // consecutive non-N bases ending here
        for (int64_t i = s0; i < s1 + k - 1 && i < n; ++i) {
            const uint8_t b = codes[i];
            if (b > 3) { run = 0; fwd = 0; continue; }
            fwd = ((fwd << 2) | b) & mask;
            ++run;
            const int64_t s = i - k + 1;
            if (run < k || s < s0) continue;
            if (!((words[fwd >> 6] >> (fwd & 63)) & 1)) continue;
            // HP-terminal exclusion: next base == last, or prev == first
            if (i + 1 < n && codes[i + 1] == b) continue;
            if (s > 0 && codes[s - 1] == codes[s]) continue;
            vp.push_back(s);
            vk.push_back((int64_t)fwd);
        }
    }
    size_t total = 0;
    for (auto& v : ppos) total += v.size();
    R->pos.reserve(total);
    R->kid.reserve(total);
    for (int c = 0; c < nchunks; ++c) {
        R->pos.insert(R->pos.end(), ppos[c].begin(), ppos[c].end());
        R->kid.insert(R->kid.end(), pkid[c].begin(), pkid[c].end());
    }
    return R;
}

int64_t hypo_solid_pos_count(void* h) {
    return (int64_t)((SolidPos*)h)->pos.size();
}
const int64_t* hypo_solid_pos_pos(void* h) {
    return ((SolidPos*)h)->pos.data();
}
const int64_t* hypo_solid_pos_kid(void* h) {
    return ((SolidPos*)h)->kid.data();
}
void hypo_solid_pos_free(void* h) { delete (SolidPos*)h; }

// ---------------------------------------------------------------------
// Simulator read composer (native twin of hypo_tpu.sim._compose_read +
// the BAM-record/FASTQ serialization of sim.make_reads): composes
// truth->draft events with truth->read error events per read, emits the
// uncompressed BAM record stream (coordinate-sorted) and the FASTQ
// text, OpenMP over reads.  Produces byte-identical output to the
// Python path (tested); exists because a 1 Gbp / 30x dataset is 300M
// reads — minutes natively vs days through the per-read Python loop.
namespace {

struct SimOut {
    std::vector<uint8_t> bam;    // concatenated length-prefixed records
    std::vector<char> fastq;     // @name\nSEQ\n+\nIII...\n per read
    std::vector<int64_t> rec_pos;   // per emitted record (bam order)
    std::vector<int64_t> rec_off;   // [n_rec + 1] offsets into bam
};

struct ComposedRead {
    std::vector<uint8_t> read;
    std::vector<uint8_t> ops;
    std::vector<uint32_t> lens;
    int64_t pos = -1;
    int nm = 0;
};

constexpr uint8_t kSimNib[5] = {1, 2, 4, 8, 15};

void compose_read(
    int64_t s, int64_t e, const uint8_t* g, const uint8_t* dbase,
    const int64_t* t2d, const int64_t* ins_dpos,
    const int64_t* d_ev_t, const uint8_t* d_kind, int64_t nd,
    const int64_t* q_t, const uint8_t* q_kind, const uint8_t* q_base,
    int64_t nq, ComposedRead& out) {
    out.read.clear(); out.ops.clear(); out.lens.clear();
    out.pos = -1; out.nm = 0;
    // merge event columns by truth coordinate (d and q arrays are
    // sorted; q may repeat a coordinate — the LAST entry wins, matching
    // the python dict semantics)
    auto emit = [&](uint8_t op, uint32_t ln) {
        if (!out.ops.empty() && out.ops.back() == op)
            out.lens.back() += ln;
        else { out.ops.push_back(op); out.lens.push_back(ln); }
    };
    int64_t di = 0, qi = 0, prev = s;
    while (true) {
        // next event column >= prev
        int64_t t = INT64_MAX;
        if (di < nd) t = std::min(t, d_ev_t[di]);
        if (qi < nq) t = std::min(t, q_t[qi]);
        if (t == INT64_MAX || t >= e) break;
        int dk = -1;
        bool has_q = false;
        int qk = -1, qb = 0;
        while (di < nd && d_ev_t[di] == t) { dk = d_kind[di]; ++di; }
        while (qi < nq && q_t[qi] == t) {
            has_q = true; qk = q_kind[qi]; qb = q_base[qi]; ++qi;
        }
        if (t > prev) {
            if (out.pos < 0) out.pos = t2d[prev];
            emit(0, (uint32_t)(t - prev));
            out.read.insert(out.read.end(), g + prev, g + t);
        }
        if (dk == 1) {               // draft insertion before t
            if (out.pos < 0) out.pos = ins_dpos[t];
            emit(2, 1);
            ++out.nm;
        }
        if (has_q && qk == 1) {      // read insertion before t
            emit(1, 1);
            ++out.nm;
            out.read.push_back((uint8_t)qb);
        }
        const bool q_emits = !has_q || qk != 2;
        const bool r_emits = dk != 2;
        uint8_t bq = 0;
        if (q_emits) bq = (!has_q || qk != 0) ? g[t] : (uint8_t)qb;
        if (q_emits && r_emits) {
            if (out.pos < 0) out.pos = t2d[t];
            emit(0, 1);
            out.nm += (bq != dbase[t]) ? 1 : 0;
            out.read.push_back(bq);
        } else if (r_emits) {
            if (out.pos < 0) out.pos = t2d[t];
            emit(2, 1);
            ++out.nm;
        } else if (q_emits) {
            emit(1, 1);
            ++out.nm;
            out.read.push_back(bq);
        }
        prev = t + 1;
    }
    if (prev < e) {
        if (out.pos < 0) out.pos = t2d[prev];
        emit(0, (uint32_t)(e - prev));
        out.read.insert(out.read.end(), g + prev, g + e);
    }
    // trim boundary deletions (real aligners never emit them)
    size_t lo = 0;
    while (lo < out.ops.size() && out.ops[lo] == 2) {
        out.pos += out.lens[lo];
        out.nm -= out.lens[lo];
        ++lo;
    }
    size_t hi = out.ops.size();
    while (hi > lo && out.ops[hi - 1] == 2) {
        --hi;
        out.nm -= out.lens[hi];
    }
    if (lo > 0 || hi < out.ops.size()) {
        out.ops.assign(out.ops.begin() + lo, out.ops.begin() + hi);
        out.lens.assign(out.lens.begin() + lo, out.lens.begin() + hi);
    }
}

}  // namespace

void* hypo_sim_reads(
    const uint8_t* g, int64_t glen, const uint8_t* dbase,
    const int64_t* t2d, const int64_t* ins_dpos,
    const int64_t* ev_t, const uint8_t* ev_kind,
    const int64_t* d_lo, const int64_t* d_hi,
    const int64_t* starts, const uint8_t* revs, int64_t n_reads,
    int rlen, int tid, const char* prefix, int64_t name0,
    const int64_t* qoff, const int64_t* q_t, const uint8_t* q_kind,
    const uint8_t* q_base, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    (void)glen;
    auto* R = new SimOut();
    std::vector<ComposedRead> reads((size_t)n_reads);
#pragma omp parallel for schedule(dynamic, 1024)
    for (int64_t i = 0; i < n_reads; ++i) {
        const int64_t s = starts[i];
        compose_read(s, s + rlen, g, dbase, t2d, ins_dpos,
                     ev_t + d_lo[i], ev_kind + d_lo[i],
                     d_hi[i] - d_lo[i],
                     q_t + qoff[i], q_kind + qoff[i], q_base + qoff[i],
                     qoff[i + 1] - qoff[i], reads[(size_t)i]);
    }
    // FASTQ in generation order; BAM sorted by pos (stable), matching
    // the python path's recs.sort(key=(tid,pos)) within this contig
    static const char* B2A = "ACGT";
    std::string name;
    for (int64_t i = 0; i < n_reads; ++i) {
        const auto& r = reads[(size_t)i];
        if (r.read.empty() || r.ops.empty()) continue;
        name = prefix;
        name += std::to_string(tid);
        name += '_';
        name += std::to_string(name0 + i);
        R->fastq.push_back('@');
        R->fastq.insert(R->fastq.end(), name.begin(), name.end());
        R->fastq.push_back('\n');
        const size_t L = r.read.size();
        if (revs[i]) {
            for (size_t j = L; j > 0; --j)
                R->fastq.push_back(B2A[3 - r.read[j - 1]]);
        } else {
            for (size_t j = 0; j < L; ++j)
                R->fastq.push_back(B2A[r.read[j]]);
        }
        R->fastq.push_back('\n');
        R->fastq.push_back('+');
        R->fastq.push_back('\n');
        R->fastq.insert(R->fastq.end(), L, 'I');
        R->fastq.push_back('\n');
    }
    std::vector<int64_t> order;
    order.reserve((size_t)n_reads);
    for (int64_t i = 0; i < n_reads; ++i)
        if (!reads[(size_t)i].read.empty() &&
            !reads[(size_t)i].ops.empty())
            order.push_back(i);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) {
                         return reads[(size_t)a].pos <
                                reads[(size_t)b].pos;
                     });
    auto put32 = [&](uint32_t v) {
        R->bam.push_back(v & 0xFF);
        R->bam.push_back((v >> 8) & 0xFF);
        R->bam.push_back((v >> 16) & 0xFF);
        R->bam.push_back((v >> 24) & 0xFF);
    };
    R->rec_off.push_back(0);
    for (int64_t i : order) {
        const auto& r = reads[(size_t)i];
        R->rec_pos.push_back(r.pos);
        name = prefix;
        name += std::to_string(tid);
        name += '_';
        name += std::to_string(name0 + i);
        const uint32_t l_qn = (uint32_t)name.size() + 1;
        const uint32_t l_seq = (uint32_t)r.read.size();
        const uint32_t n_cig = (uint32_t)r.ops.size();
        const uint16_t flag = revs[i] ? 16 : 0;
        const uint32_t data_len = 32 + l_qn + 4 * n_cig +
                                  (l_seq + 1) / 2 + l_seq + 7;
        put32(data_len);
        put32((uint32_t)tid);
        put32((uint32_t)r.pos);
        R->bam.push_back((uint8_t)l_qn);      // l_read_name
        R->bam.push_back(60);                 // mapq
        R->bam.push_back(0); R->bam.push_back(0);          // bin
        R->bam.push_back(n_cig & 0xFF);
        R->bam.push_back((n_cig >> 8) & 0xFF);
        R->bam.push_back(flag & 0xFF);
        R->bam.push_back((flag >> 8) & 0xFF);
        put32(l_seq);
        put32((uint32_t)-1);   // mate tid
        put32((uint32_t)-1);   // mate pos
        put32(0);              // tlen
        R->bam.insert(R->bam.end(), name.begin(), name.end());
        R->bam.push_back(0);
        for (uint32_t c = 0; c < n_cig; ++c)
            put32((r.lens[c] << 4) | r.ops[c]);
        for (uint32_t j = 0; j < l_seq; j += 2) {
            uint8_t hi_nib = kSimNib[r.read[j]];
            uint8_t lo_nib =
                (j + 1 < l_seq) ? kSimNib[r.read[j + 1]] : 0;
            R->bam.push_back((uint8_t)((hi_nib << 4) | lo_nib));
        }
        R->bam.insert(R->bam.end(), l_seq, 0xFF);   // qual
        R->bam.push_back('N'); R->bam.push_back('M');
        R->bam.push_back('i');
        put32((uint32_t)r.nm);
        R->rec_off.push_back((int64_t)R->bam.size());
    }
    return R;
}

int64_t hypo_sim_bam_size(void* h) {
    return (int64_t)((SimOut*)h)->bam.size();
}
int64_t hypo_sim_nrec(void* h) {
    return (int64_t)((SimOut*)h)->rec_pos.size();
}
const int64_t* hypo_sim_rec_pos(void* h) {
    return ((SimOut*)h)->rec_pos.data();
}
const int64_t* hypo_sim_rec_off(void* h) {
    return ((SimOut*)h)->rec_off.data();
}
int64_t hypo_sim_fastq_size(void* h) {
    return (int64_t)((SimOut*)h)->fastq.size();
}
const uint8_t* hypo_sim_bam(void* h) { return ((SimOut*)h)->bam.data(); }
const char* hypo_sim_fastq(void* h) {
    return ((SimOut*)h)->fastq.data();
}
void hypo_sim_free(void* h) { delete (SimOut*)h; }

// ---------------------------------------------------------------------
// Per-MegaWindow minimizer tables (reference
// Contig::initialise_minimserinfo, src/Contig.cpp:455-524): forward-
// strand minimizers (k=mk, w=mw) of each MW's draft slice, keeping
// only values unique within the MW and not poly-base; emitted with
// CONTIG-ABSOLUTE positions into one flat store (OpenMP over MWs).
// Replaces ~1M per-MW Python objects + scans at 100 Mbp scale.
namespace {
struct MwMin {
    std::vector<int64_t> off;   // [n_mw + 1]
    std::vector<int64_t> vals;
    std::vector<int64_t> pos;   // contig-absolute minimizer starts
};
}  // namespace

void* hypo_mw_minimizer_build(
    const uint8_t* codes,            // contig draft (byte codes, may have N)
    const int64_t* beg, const int64_t* end, int64_t n_mw,
    int mk, int mw_w, int64_t min_len,
    const int64_t* poly, int n_poly, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    auto* R = new MwMin();
    const uint64_t mask = (1ULL << (2 * mk)) - 1;
    std::vector<std::vector<int64_t>> pvals(n_mw), ppos(n_mw);
#pragma omp parallel
    {
        std::vector<std::pair<uint64_t, int64_t>> deque;
        std::vector<std::pair<uint64_t, int64_t>> kept;  // (val, pos)
        std::vector<std::pair<uint64_t, int64_t>> srt;
#pragma omp for schedule(dynamic, 16)
        for (int64_t s = 0; s < n_mw; ++s) {
            const int64_t b = beg[s], e = end[s];
            if (e - b <= min_len) continue;    // small MW: empty table
            kept.clear();
            deque.clear();
            // N semantics follow the minimizer_scan_ref oracle
            // (reference src/Contig.cpp:474-502): N resets only the
            // not-N run counter; the rolling kmer, deque and processed
            // counter are NOT reset
            uint64_t fwd = 0;
            int64_t processed = 0, last_pos = e + 1, valid_run = 0;
            size_t head = 0;
            for (int64_t i = b; i < e; ++i) {
                const uint8_t c = codes[i];
                if (c > 3) { valid_run = 0; continue; }
                ++valid_run;
                fwd = ((fwd << 2) | c) & mask;
                if (valid_run >= mk) {
                    while (deque.size() > head && deque.back().first > fwd)
                        deque.pop_back();
                    deque.emplace_back(fwd, i);
                    while (deque[head].second + mw_w <= i) ++head;
                    ++processed;
                    if (processed >= mw_w) {
                        const int64_t pos = deque[head].second - mk + 1;
                        if (pos != last_pos)
                            kept.emplace_back(deque[head].first, pos);
                        last_pos = pos;
                    }
                }
            }
            if (kept.empty()) continue;
            // uniqueness within the MW + poly filter
            srt = kept;
            std::sort(srt.begin(), srt.end());
            auto& ov = pvals[s];
            auto& op = ppos[s];
            for (const auto& kv : kept) {
                auto lo = std::lower_bound(
                    srt.begin(), srt.end(),
                    std::make_pair(kv.first, (int64_t)INT64_MIN));
                int cnt = 0;
                for (auto it = lo; it != srt.end() && it->first == kv.first;
                     ++it)
                    ++cnt;
                if (cnt != 1) continue;
                bool is_poly = false;
                for (int p = 0; p < n_poly; ++p)
                    if ((int64_t)kv.first == poly[p]) { is_poly = true;
                                                       break; }
                if (is_poly) continue;
                ov.push_back((int64_t)kv.first);
                op.push_back(kv.second);
            }
        }
    }
    R->off.assign(n_mw + 1, 0);
    for (int64_t s = 0; s < n_mw; ++s)
        R->off[s + 1] = R->off[s] + (int64_t)pvals[s].size();
    R->vals.reserve(R->off[n_mw]);
    R->pos.reserve(R->off[n_mw]);
    for (int64_t s = 0; s < n_mw; ++s) {
        R->vals.insert(R->vals.end(), pvals[s].begin(), pvals[s].end());
        R->pos.insert(R->pos.end(), ppos[s].begin(), ppos[s].end());
    }
    return R;
}

int64_t hypo_mw_min_total(void* h) {
    return ((MwMin*)h)->off.back();
}
const int64_t* hypo_mw_min_off(void* h) { return ((MwMin*)h)->off.data(); }
const int64_t* hypo_mw_min_vals(void* h) { return ((MwMin*)h)->vals.data(); }
const int64_t* hypo_mw_min_pos(void* h) { return ((MwMin*)h)->pos.data(); }
void hypo_mw_min_free(void* h) { delete (MwMin*)h; }

// ---------------------------------------------------------------------
// Minimizer coverage/support update (reference
// Alignment::update_minimisers_support, src/Alignment.cpp:134-220).
//
// starts: stage-1 region boundary positions (nstarts entries, last is
// the contig end dummy).  Per-MegaWindow minimizer tables are flattened:
// mw_off[n_mw+1] offsets into m_vals/m_abs (values and absolute
// positions); coverage/support (int32) flattened likewise and
// accumulated atomically.
void hypo_minimizer_support(const int64_t* starts, int64_t nstarts,
                            int is_win_even,
                            const int64_t* mw_off, int64_t n_mw,
                            const int64_t* m_vals, const int64_t* m_abs,
                            const uint8_t* codes, const int64_t* code_off,
                            const int64_t* rb, const int64_t* re,
                            int64_t n_aln, int mk, int mw_w,
                            int32_t* coverage, int32_t* support,
                            int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    const int64_t nreg = nstarts - 1;
    const uint64_t mask = (1ULL << (2 * mk)) - 1;
#pragma omp parallel
    {
        std::vector<std::pair<uint64_t, int32_t>> rmin;  // (val, read pos)
        std::vector<std::pair<uint64_t, int64_t>> deque;
        std::vector<uint8_t> qbuf;
#pragma omp for schedule(dynamic, 64)
        for (int64_t a = 0; a < n_aln; ++a) {
            const int64_t arb = rb[a], are = re[a];
            int64_t first =
                (std::lower_bound(starts, starts + nstarts, arb + 1) -
                 starts) - 1;
            int64_t last =
                std::lower_bound(starts, starts + nstarts, are) - starts;
            int64_t first_w =
                ((first % 2 == 0) == (bool)is_win_even) ? first : first + 1;
            int64_t last_w =
                ((last % 2 == 0) == (bool)is_win_even) ? last : last - 1;
            if (last_w < first_w) continue;

            // forward-strand minimizer scan of the read (deque semantics
            // of reference src/Contig.cpp:474-502; reads are N-free)
            const int64_t qlen = code_off[a + 1] - code_off[a];
            unpack2_into(codes, code_off[a], qlen, qbuf);
            const uint8_t* q = qbuf.data();
            rmin.clear();
            deque.clear();
            {
                uint64_t fwd = 0;
                int64_t processed = 0, last_pos = qlen + 1;
                size_t head = 0;
                for (int64_t i = 0; i < qlen; ++i) {
                    fwd = ((fwd << 2) | q[i]) & mask;
                    if (i >= mk - 1) {
                        while (deque.size() > head &&
                               deque.back().first > fwd)
                            deque.pop_back();
                        deque.emplace_back(fwd, i);
                        while (deque[head].second + mw_w <= i) ++head;
                        ++processed;
                        if (processed >= mw_w) {
                            int64_t pos = deque[head].second - mk + 1;
                            if (pos != last_pos)
                                rmin.emplace_back(deque[head].first, pos);
                            last_pos = pos;
                        }
                    }
                }
            }
            std::sort(rmin.begin(), rmin.end());

            const int64_t num_cbases = are - arb;
            for (int64_t i = first_w; i <= last_w; i += 2) {
                if (i >= nreg) break;
                const int64_t minfoidx =
                    is_win_even ? i / 2 : (i - 1) / 2;
                if (minfoidx >= n_mw) break;
                const int64_t o0 = mw_off[minfoidx];
                const int64_t o1 = mw_off[minfoidx + 1];
                for (int64_t t = o0; t < o1; ++t) {
                    const int64_t ap = m_abs[t];
                    if (ap < arb || ap >= are) continue;
                    auto* cslot = reinterpret_cast<std::atomic<int32_t>*>(
                        &coverage[t]);
                    cslot->fetch_add(1, std::memory_order_relaxed);
                    if (rmin.empty()) continue;
                    const uint64_t val = (uint64_t)m_vals[t];
                    auto lo = std::lower_bound(
                        rmin.begin(), rmin.end(),
                        std::make_pair(val, (int32_t)INT32_MIN));
                    if (lo == rmin.end() || lo->first != val) continue;
                    const int64_t c_dist = ap - arb;
                    const int64_t r_left =
                        std::max<int64_t>(c_dist - 2 * mk, 0);
                    const int64_t r_right =
                        std::min<int64_t>(num_cbases, c_dist + 3 * mk);
                    int32_t cnt = 0;
                    for (; lo != rmin.end() && lo->first == val; ++lo)
                        if (lo->second >= r_left && lo->second <= r_right)
                            ++cnt;
                    if (cnt) {
                        auto* sslot =
                            reinterpret_cast<std::atomic<int32_t>*>(
                                &support[t]);
                        sslot->fetch_add(cnt, std::memory_order_relaxed);
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------
// Strong regions (reference Contig::prepare_for_division,
// src/Contig.cpp:75-139): the sequential part of the two-tier scan over
// a contig's solid positions, twin of segment/sr.scan_strong_regions.
// tier[i] is 2 for the 80% tier, 1 for the 40% tier and 0 for neither
// (segment/sr.sr_tiers).  sr_pos and sr_len hold n entries, anchors
// 2n + 1 (an SR closes on a valid k-mer, so there are at most n);
// returns the number of SRs.
int64_t hypo_strong_regions(const int64_t* pos, const int64_t* kids,
                            const uint8_t* tier, int64_t n, int k,
                            int64_t* sr_pos, int64_t* sr_len,
                            int64_t* anchors) {
    int64_t nsr = 0;
    bool in_sr = false, pvs_80 = true;
    int64_t first_kind = 0, last_kind = 0, first_pos = 0, last_pos = 0;
    anchors[0] = 0;
    auto close = [&]() {
        sr_pos[nsr] = first_pos;
        sr_len[nsr] = last_pos - first_pos;
        anchors[1 + 2 * nsr] = kids[first_kind];
        anchors[2 + 2 * nsr] = kids[last_kind];
        ++nsr;
        in_sr = false;
        pvs_80 = true;
    };
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p = pos[i];
        if (in_sr && p > last_pos) close();
        bool valid = false;
        if (tier[i] == 2) {
            valid = true;
            pvs_80 = true;
        } else if (tier[i] == 1) {
            valid = pvs_80;
            pvs_80 = false;
        }
        if (valid) {
            if (!in_sr) {
                first_kind = i;
                first_pos = p;
                in_sr = true;
            }
            last_kind = i;
            last_pos = p + k;
        }
        if (in_sr && p == last_pos) close();
    }
    if (in_sr) close();
    return nsr;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Region division (reference Contig::divide / Contig::force_divide,
// src/Contig.cpp:187-245, 526-711): a contig's MegaWindows cut at
// supported minimizers, oversized stretches at homopolymer-safe points,
// and its SRs between them, in one call; twin of segment/regions.divide
// and force_divide driven by pipeline/contig.Contig.divide_into_regions,
// with the reference's typing quirks ((n,m) -> OTHER in force_divide's
// single-window case).
namespace {
enum : uint8_t {
    RT_SWS = 0, RT_SW, RT_WS, RT_MWM, RT_MW, RT_WM, RT_SWM, RT_MWS,
    RT_OTHER, RT_LONG, RT_SR, RT_MSR
};

struct Regions {
    std::vector<int64_t> starts;
    std::vector<uint8_t> types;
    std::vector<int64_t> infos;
    // scratch of one MegaWindow
    std::vector<int64_t> supp_pos, supp_min, cut_pos;
    std::vector<size_t> cuts;

    void add(int64_t s, uint8_t t, int64_t info = 0) {
        starts.push_back(s);
        types.push_back(t);
        infos.push_back(info);
    }
};

void force_divide(Regions& R, const uint8_t* codes, int64_t beg,
                  int64_t end, char pvs, char nxt, int64_t ideal,
                  int64_t search_th) {
    auto& cut_pos = R.cut_pos;
    cut_pos.clear();
    int64_t start = beg, remaining = end - start;
    while (remaining > ideal) {
        int64_t search = start + search_th;
        while (search < end) {
            const uint8_t base = codes[search];
            if (base == codes[search - 1])
                search += 1;
            else if (search + 1 < end && base == codes[search + 1])
                search += 2;
            else if (search + 2 < end &&
                     codes[search + 2] == codes[search + 1])
                search += 3;
            else
                break;
        }
        if (search >= end) break;
        cut_pos.push_back(start);
        start = search + 1;
        remaining = end - start;
    }
    if (start < end) cut_pos.push_back(start);

    if (cut_pos.size() == 1) {
        uint8_t t = RT_OTHER;   // (n,m) and (n,n) included
        if (pvs == 's')
            t = nxt == 's' ? RT_SWS : nxt == 'm' ? RT_SWM : RT_SW;
        else if (pvs == 'm')
            t = nxt == 's' ? RT_MWS : nxt == 'm' ? RT_MWM : RT_MW;
        else if (nxt == 's')
            t = RT_WS;
        R.add(beg, t);
        return;
    }
    R.add(beg, pvs == 's' ? RT_SW : pvs == 'm' ? RT_MW : RT_OTHER);
    for (size_t i = 1; i + 1 < cut_pos.size(); ++i)
        R.add(cut_pos[i], RT_OTHER);
    R.add(cut_pos.back(), nxt == 's' ? RT_WS : nxt == 'm' ? RT_WM : RT_OTHER);
}

void divide(Regions& R, const uint8_t* codes, const int64_t* m_vals,
            const int64_t* m_pos, const uint8_t* m_keep, int64_t nm,
            int64_t beg, int64_t end, char pvs, char nxt, int mk,
            int64_t ideal, int64_t search_th) {
    const int64_t too_large = 2 * ideal;
    auto& supp_pos = R.supp_pos;
    auto& supp_min = R.supp_min;
    auto& cuts = R.cuts;
    supp_pos.clear();
    supp_min.clear();
    cuts.clear();
    for (int64_t i = 0; i < nm; ++i)
        if (m_keep[i] && m_pos[i] + mk < end) {
            supp_pos.push_back(m_pos[i]);
            supp_min.push_back(m_vals[i]);
        }
    // cutting minimizers, greedily at <= ideal spacing
    int64_t remaining = end - beg, start = beg;
    const size_t ns = supp_pos.size();
    for (size_t mi = 0; mi < ns; ++mi) {
        if (remaining <= ideal) break;
        const bool should_break =
            mi == ns - 1 || supp_pos[mi + 1] > ideal + start;
        if (should_break && supp_pos[mi] > start) {
            cuts.push_back(mi);
            start = supp_pos[mi] + mk;
            remaining = end - start;
        }
    }
    if (cuts.empty()) {
        if (end > beg + too_large) {
            force_divide(R, codes, beg, end, pvs, nxt, ideal, search_th);
        } else {
            uint8_t t = RT_OTHER;
            if (pvs == 's')
                t = nxt == 's' ? RT_SWS : RT_SW;
            else if (nxt == 's')
                t = RT_WS;
            R.add(beg, t);
        }
        return;
    }
    // first window
    int64_t win_end = supp_pos[cuts[0]];
    if (win_end > beg + too_large)
        force_divide(R, codes, beg, win_end, pvs, 'm', ideal, search_th);
    else
        R.add(beg, pvs == 's' ? RT_SWM : RT_WM);
    // internal: an MSR at each cut minimizer, then a window to the next
    for (size_t c = 1; c < cuts.size(); ++c) {
        const size_t p = cuts[c - 1];
        R.add(supp_pos[p], RT_MSR, supp_min[p]);
        const int64_t win_start = supp_pos[p] + mk;
        win_end = supp_pos[cuts[c]];
        if (win_end > too_large + win_start)
            force_divide(R, codes, win_start, win_end, 'm', 'm', ideal,
                         search_th);
        else
            R.add(win_start, RT_MWM);
    }
    // last: an MSR, then the closing window to `end`
    const size_t p = cuts.back();
    R.add(supp_pos[p], RT_MSR, supp_min[p]);
    const int64_t win_start = supp_pos[p] + mk;
    if (end > too_large + win_start)
        force_divide(R, codes, win_start, end, 'm', nxt, ideal, search_th);
    else
        R.add(win_start, nxt == 's' ? RT_MWS : RT_MW);
}
}  // namespace

extern "C" {

// s1: the stage-1 boundaries (SR and MegaWindow edges, the contig's end
// last), ns1 of them; MegaWindow m's minimizers are [mw_off[m],
// mw_off[m + 1]) of mw_vals / mw_pos (contig-absolute), mw_keep 1 where
// the minimizer's coverage and support pass.  Regions in contig order,
// without the end dummy: start, type (RT_*), info (an SR's rank from 1,
// an MSR's minimizer, else 0).
void* hypo_divide_regions(const uint8_t* codes, int64_t clen,
                          const int64_t* s1, int64_t ns1, int is_win_even,
                          const int64_t* mw_off, const int64_t* mw_vals,
                          const int64_t* mw_pos, const uint8_t* mw_keep,
                          int mk, int64_t ideal, int64_t search_th) {
    auto* R = new Regions();
    int64_t sr_rank = 1;
    for (int64_t j = 0; j + 1 < ns1; ++j) {
        const int64_t s = s1[j], e = s1[j + 1];
        if ((j % 2 == 0) == (is_win_even != 0)) {   // a MegaWindow
            const int64_t m = is_win_even ? j / 2 : (j - 1) / 2;
            const int64_t o0 = mw_off[m], o1 = mw_off[m + 1];
            divide(*R, codes, mw_vals + o0, mw_pos + o0, mw_keep + o0,
                   o1 - o0, s, e, j == 0 ? 'n' : 's', e == clen ? 'n' : 's',
                   mk, ideal, search_th);
        } else {
            R->add(s, RT_SR, sr_rank++);
        }
    }
    return R;
}

int64_t hypo_regions_count(void* h) {
    return (int64_t)((Regions*)h)->starts.size();
}
const int64_t* hypo_regions_starts(void* h) {
    return ((Regions*)h)->starts.data();
}
const uint8_t* hypo_regions_types(void* h) {
    return ((Regions*)h)->types.data();
}
const int64_t* hypo_regions_infos(void* h) {
    return ((Regions*)h)->infos.data();
}
void hypo_regions_free(void* h) { delete (Regions*)h; }

}  // extern "C"

// ---------------------------------------------------------------------
// Arm extraction (reference Alignment::find_short_arms /
// find_long_arms / find_bp / prepare_short_arm,
// src/Alignment.cpp:222-511), OpenMP over alignments.
//
// Mirrors hypo_tpu/pipeline/alignment.py exactly: the CIGAR break-point
// walk against region boundaries, then per-window anchor re-search on
// flanking SR k-mers / minimizers via byte-pattern matching.  Results
// are stored in a handle and read back via flat-array getters, in
// (alignment, emission) order so downstream window fill order — and
// therefore POA tie-breaking — is identical to the Python path.

namespace {

constexpr int OP_S = 4, OP_H = 5;
constexpr int kConsumes[9] = {3, 1, 2, 2, 1, 0, 0, 3, 3};
constexpr int R_SWS = 0, R_SW = 1, R_WS = 2, R_MWM = 3, R_MW = 4,
              R_WM = 5, R_SWM = 6, R_MWS = 7, R_SR = 10, R_MSR = 11;
constexpr int ARM_INTERNAL = 0, ARM_PREFIX = 1, ARM_SUFFIX = 2,
              ARM_EMPTY = 3;

// int32 throughout: per-batch alignment index < ~100M, region index
// < ~10M per contig, query offsets < read length — halves the arm
// table (the largest transient at 100 Mbp is ~23M rows)
struct ArmOut {
    int32_t aln;
    int32_t windex;
    int32_t qb, qe;
    uint8_t armtype;
};

struct ArmsResult {
    std::vector<int32_t> aln, windex, qb, qe;
    std::vector<uint8_t> armtype;
};

void decode_kmer(int64_t val, int k, uint8_t* out) {
    for (int i = k - 1; i >= 0; --i) {
        out[i] = (uint8_t)(val & 3);
        val >>= 2;
    }
}

// bytes.rfind/find of a k-byte pattern fully inside [s0, s1)
int64_t find_pat(const uint8_t* hay, int64_t s0, int64_t s1,
                 const uint8_t* pat, int k, bool first) {
    if (s1 - s0 < k) return -1;
    if (first) {
        for (int64_t i = s0; i <= s1 - k; ++i)
            if (!memcmp(hay + i, pat, k)) return i;
    } else {
        for (int64_t i = s1 - k; i >= s0; --i)
            if (!memcmp(hay + i, pat, k)) return i;
    }
    return -1;
}

// CIGAR break-point walk (reference find_bp, Alignment.cpp:321-406)
void find_bp(const uint32_t* cig, int64_t ncig, int64_t rb,
             const int64_t* starts, const uint8_t* rtype,
             int64_t beg_ind, int64_t end_ind,
             std::vector<int64_t>& results) {
    results.clear();
    int64_t cur_ref = rb;
    int64_t cpi = beg_ind + 1;
    int64_t next_ref = starts[cpi];
    int64_t cur_q = 0;
    bool is_corner = false;
    for (int64_t idx = 0; idx < ncig; ++idx) {
        const int op = cig[idx] & 0xF;
        int64_t oplen = cig[idx] >> 4;
        if (op == OP_S || op == OP_H) continue;
        const int ctype = kConsumes[op];
        if (ctype == 3) {
            if (is_corner) {
                results.push_back(cur_q);
                is_corner = false;
                ++cpi;
                next_ref = starts[cpi];
            }
            while (cur_ref + oplen >= next_ref && !is_corner) {
                const int64_t diff = next_ref - cur_ref;
                cur_ref = next_ref;
                cur_q += diff;
                oplen -= diff;
                if (oplen > 0) {
                    results.push_back(cur_q);
                    ++cpi;
                    next_ref = starts[cpi];
                } else {
                    is_corner = true;
                }
            }
            if (oplen > 0) { cur_ref += oplen; cur_q += oplen; }
        } else if (ctype & 2) {
            if (is_corner) {
                results.push_back(cur_q);
                is_corner = false;
                ++cpi;
                next_ref = starts[cpi];
            }
            while (cur_ref + oplen >= next_ref && !is_corner) {
                const int64_t diff = next_ref - cur_ref;
                cur_ref = next_ref;
                oplen -= diff;
                if (oplen > 0) {
                    results.push_back(cur_q);
                    ++cpi;
                    next_ref = starts[cpi];
                } else {
                    is_corner = true;
                }
            }
            if (oplen > 0) cur_ref += oplen;
        } else if (ctype & 1) {
            if (is_corner) {
                if (rtype[cpi - 1] == R_SR || rtype[cpi - 1] == R_MSR)
                    results.push_back(cur_q);
                else
                    results.push_back(cur_q + oplen);
                ++cpi;
                next_ref = starts[cpi];
                is_corner = false;
            }
            cur_q += oplen;
        }
        if (cpi == end_ind) break;
    }
}

// prepare_short_arm (reference Alignment.cpp:408-511)
void prepare_short_arm(const uint8_t* q, int64_t qae, int k, int mk,
                       int64_t windex, int64_t qb0, int64_t qe0,
                       int armtype, const int64_t* starts,
                       const uint8_t* rtype, const int64_t* rinfo,
                       const int64_t* anchors, int64_t aln_idx,
                       int short_arm_coef, std::vector<ArmOut>& out) {
    const int64_t cur_pos = starts[windex];
    const int64_t next_pos = starts[windex + 1];
    if (next_pos - cur_pos > (int64_t)short_arm_coef * (qe0 - qb0))
        return;
    const int wtype = rtype[windex];
    bool valid = true;
    int64_t q_beg = qb0, q_end = qe0;
    uint8_t pat[64];
    // preceding SR's last kmer
    if ((wtype == R_SWS || wtype == R_SW || wtype == R_SWM) &&
        armtype != ARM_SUFFIX) {
        if (q_beg < k) {
            valid = false;
        } else {
            const int64_t rank_sr = rinfo[windex - 1];
            decode_kmer(anchors[2 * rank_sr], k, pat);
            if (memcmp(q + q_beg - k, pat, k) != 0) {
                const int64_t s0 = q_beg < 2 * k ? 0 : q_beg - 2 * k;
                const int64_t s1 =
                    q_end < q_beg + k ? q_end : q_beg + k;
                const int64_t hit = find_pat(q, s0, s1, pat, k, false);
                if (hit >= 0) q_beg = hit + k; else valid = false;
            }
        }
    }
    // succeeding SR's first kmer
    if (valid && (wtype == R_SWS || wtype == R_WS || wtype == R_MWS) &&
        armtype != ARM_PREFIX) {
        if (q_end + k > qae) {
            valid = false;
        } else {
            const int64_t rank_sr = rinfo[windex + 1];
            decode_kmer(anchors[2 * rank_sr - 1], k, pat);
            if (memcmp(q + q_end, pat, k) != 0) {
                const int64_t s0 =
                    q_end < q_beg + k ? q_beg : q_end - k;
                const int64_t s1 =
                    qae < q_end + 2 * k ? qae : q_end + 2 * k;
                const int64_t hit = find_pat(q, s0, s1, pat, k, true);
                if (hit >= 0) q_end = hit; else valid = false;
            }
        }
    }
    // preceding minimizer
    if (valid && (wtype == R_MWM || wtype == R_MW || wtype == R_MWS) &&
        armtype != ARM_SUFFIX) {
        if (q_beg < mk) {
            valid = false;
        } else {
            decode_kmer(rinfo[windex - 1], mk, pat);
            if (memcmp(q + q_beg - mk, pat, mk) != 0) {
                const int64_t s0 = q_beg < 3 * mk ? 0 : q_beg - 3 * mk;
                const int64_t s1 =
                    q_end < q_beg + 2 * mk ? q_end : q_beg + 2 * mk;
                const int64_t hit = find_pat(q, s0, s1, pat, mk, false);
                if (hit >= 0) q_beg = hit + mk; else valid = false;
            }
        }
    }
    // succeeding minimizer
    if (valid && (wtype == R_MWM || wtype == R_WM || wtype == R_SWM) &&
        armtype != ARM_PREFIX) {
        if (q_end + mk > qae) {
            valid = false;
        } else {
            decode_kmer(rinfo[windex + 1], mk, pat);
            if (memcmp(q + q_end, pat, mk) != 0) {
                const int64_t s0 =
                    q_end < q_beg + 2 * mk ? q_beg : q_end - 2 * mk;
                const int64_t s1 =
                    qae < q_end + 3 * mk ? qae : q_end + 3 * mk;
                const int64_t hit = find_pat(q, s0, s1, pat, mk, true);
                if (hit >= 0) q_end = hit; else valid = false;
            }
        }
    }
    if (valid && q_beg < q_end)
        out.push_back({(int32_t)aln_idx, (int32_t)windex,
                       (int32_t)q_beg, (int32_t)q_end,
                       (uint8_t)armtype});
}

}  // namespace

extern "C" {

// is_long = 0: short arms with anchoring; windex is the region index.
// is_long = 1: long arms (no anchoring, no short_arm_coef gate);
// windex is mapped through true_id.
void* hypo_find_arms(
    const int64_t* starts, const uint8_t* rtype, const int64_t* rinfo,
    const int64_t* anchors, const int64_t* true_id, int64_t nstarts,
    int k, int mk, int short_arm_coef, int is_long,
    const uint8_t* codes, const int64_t* code_off, const uint32_t* cig,
    const int64_t* cig_off, const int64_t* rb, const int64_t* re,
    int64_t n_aln, int nthreads) {
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
#endif
    auto* res = new ArmsResult();
    // contiguous per-chunk buffers instead of one std::vector per
    // alignment (20M tiny heap objects cost GBs of allocator traffic
    // at 100 Mbp scale); chunk-order concatenation preserves the
    // (alignment, emission) output order exactly
    const int nchunks = (int)std::min<int64_t>(
        std::max<int64_t>(1, n_aln / 4096),
#ifdef _OPENMP
        8LL * std::max(1, omp_get_max_threads()));
#else
        8LL);
#endif
    std::vector<std::vector<ArmOut>> per_chunk(nchunks);
#pragma omp parallel
    {
        std::vector<int64_t> bp;
        std::vector<uint8_t> qbuf;
#pragma omp for schedule(dynamic, 1)
        for (int c = 0; c < nchunks; ++c) {
        auto& out = per_chunk[c];
        const int64_t a0 = n_aln * c / nchunks;
        const int64_t a1 = n_aln * (c + 1) / nchunks;
        for (int64_t a = a0; a < a1; ++a) {
            const int64_t arb = rb[a], are = re[a];
            int64_t b_ind =
                std::lower_bound(starts, starts + nstarts, arb) - starts;
            if (b_ind >= nstarts || starts[b_ind] != arb) --b_ind;
            const int64_t e_ind =
                std::lower_bound(starts, starts + nstarts, are) - starts;
            if (e_ind - b_ind <= 1) continue;
            const int64_t qae = code_off[a + 1] - code_off[a];
            unpack2_into(codes, code_off[a], qae, qbuf);
            const uint8_t* q = qbuf.data();
            find_bp(cig + cig_off[a], cig_off[a + 1] - cig_off[a], arb,
                    starts, rtype, b_ind, e_ind, bp);
            const bool sr_like0 =
                rtype[b_ind] == R_SR || rtype[b_ind] == R_MSR;
            int armtype =
                starts[b_ind] != arb ? ARM_SUFFIX : ARM_INTERNAL;
            if (is_long) {
                // appended even when zero-length (python parity: the
                // first/last long arms are never EMPTY-classified)
                if (rtype[b_ind] != R_SR)
                    out.push_back({(int32_t)a, (int32_t)true_id[b_ind],
                                   0, (int32_t)bp[0],
                                   (uint8_t)armtype});
            } else if (!sr_like0) {
                prepare_short_arm(q, qae, k, mk, b_ind, 0, bp[0],
                                  armtype, starts, rtype, rinfo, anchors,
                                  a, short_arm_coef, out);
            }
            int64_t bp_ind = 0;
            for (int64_t ind = b_ind + 1; ind < e_ind - 1; ++ind) {
                const bool sr_like =
                    is_long ? (rtype[ind] == R_SR)
                            : (rtype[ind] == R_SR ||
                               rtype[ind] == R_MSR);
                if (!sr_like) {
                    const int64_t wx = is_long ? true_id[ind] : ind;
                    if (bp[bp_ind + 1] == bp[bp_ind]) {
                        out.push_back({(int32_t)a, (int32_t)wx, 0, 0,
                                       ARM_EMPTY});
                    } else if (is_long) {
                        out.push_back({(int32_t)a, (int32_t)wx,
                                       (int32_t)bp[bp_ind],
                                       (int32_t)bp[bp_ind + 1],
                                       ARM_INTERNAL});
                    } else {
                        prepare_short_arm(q, qae, k, mk, ind, bp[bp_ind],
                                          bp[bp_ind + 1], ARM_INTERNAL,
                                          starts, rtype, rinfo, anchors,
                                          a, short_arm_coef, out);
                    }
                }
                ++bp_ind;
            }
            // _pos_marked(starts, re)
            const int64_t mi =
                std::lower_bound(starts, starts + nstarts, are) - starts;
            const bool marked = mi < nstarts && starts[mi] == are;
            armtype = marked ? ARM_INTERNAL : ARM_PREFIX;
            const bool sr_likeE =
                is_long ? (rtype[e_ind - 1] == R_SR)
                        : (rtype[e_ind - 1] == R_SR ||
                           rtype[e_ind - 1] == R_MSR);
            if (!sr_likeE) {
                if (is_long) {
                    out.push_back({(int32_t)a,
                                   (int32_t)true_id[e_ind - 1],
                                   (int32_t)bp[bp_ind], (int32_t)qae,
                                   (uint8_t)armtype});
                } else {
                    prepare_short_arm(q, qae, k, mk, e_ind - 1,
                                      bp[bp_ind], qae, armtype, starts,
                                      rtype, rinfo, anchors, a,
                                      short_arm_coef, out);
                }
            }
        }
        }
    }
    size_t total = 0;
    for (auto& v : per_chunk) total += v.size();
    res->aln.reserve(total);
    res->windex.reserve(total);
    res->qb.reserve(total);
    res->qe.reserve(total);
    res->armtype.reserve(total);
    for (auto& v : per_chunk)
        for (const auto& o : v) {
            res->aln.push_back(o.aln);
            res->windex.push_back(o.windex);
            res->qb.push_back(o.qb);
            res->qe.push_back(o.qe);
            res->armtype.push_back(o.armtype);
        }
    return res;
}

int64_t hypo_arms_count(void* h) {
    return (int64_t)((ArmsResult*)h)->aln.size();
}
const int32_t* hypo_arms_aln(void* h) { return ((ArmsResult*)h)->aln.data(); }
const int32_t* hypo_arms_windex(void* h) { return ((ArmsResult*)h)->windex.data(); }
const int32_t* hypo_arms_qb(void* h) { return ((ArmsResult*)h)->qb.data(); }
const int32_t* hypo_arms_qe(void* h) { return ((ArmsResult*)h)->qe.data(); }
const uint8_t* hypo_arms_type(void* h) { return ((ArmsResult*)h)->armtype.data(); }
void hypo_arms_free(void* h) { delete (ArmsResult*)h; }

}  // extern "C"

// ---------------------------------------------------------------------
// Device tile preparation: the host side of the full-device POA runner
// (hypo_tpu/poa/full_runner.py) without per-window Python work.
//
// Phase A (hypo_tile_jobs, per contig): apply the window dispatch rules
// (reference src/Window.cpp:44-61), build each short window's marker-
// flanked sequence list (Window.cpp:87-132: internal J..O kNW, prefix
// J.. kLOV in reverse order, suffix ..O kROV), deduplicate identical
// (seq, mode) arms into weighted entries, settle trivial windows
// (single distinct NW arm => that arm is the exact consensus), and emit
// flat job/ext arrays in GLOBAL codes (ACGTJO = 0..5).
// Phase B (hypo_tile_pack): pack one fixed-shape tile from the sorted
// job order — arm pool deduplicated ACROSS windows, per-window index
// table — mirroring FullDeviceRunner._take_tile/_dispatch_tile.
// Phase C (hypo_tile_finalize): unpack the device's nibble-packed
// consensus rows into per-job ASCII, stripping the J/O markers.

namespace {

struct TileJobs {
    std::vector<uint8_t> flag;       // per region: 0 skip, 1 direct,
                                     // 2 device job, 3 host fallback
    std::vector<int64_t> cons_off;   // [n_reg + 1] into cons_buf
    std::vector<uint8_t> cons_buf;   // ASCII direct consensus
    std::vector<int64_t> job_windex;
    std::vector<int32_t> job_next;
    std::vector<int32_t> job_maxlen;
    std::vector<int64_t> job_ext_off;  // [njobs + 1]
    std::vector<int32_t> ext_len;
    std::vector<int8_t> ext_mode;
    std::vector<int32_t> ext_w;
    std::vector<int64_t> ext_off;      // [n_ext + 1] into ext_buf
    std::vector<int8_t> ext_buf;       // GLOBAL codes 0..5
};

constexpr int8_t G_J = 4, G_O = 5;
constexpr int M_NW = 0, M_LOV = 1, M_ROV = 2;
const char G_ALPHA[7] = "ACGTJO";

}  // namespace

extern "C" {

void* hypo_tile_jobs(
    const uint8_t* ctg_codes, const int64_t* reg_starts, int64_t n_reg,
    const uint8_t* wflag,       // [n_reg] 1 = device-eligible short win
    const uint8_t* use_presuf,  // [n_reg]
    const int32_t* t_windex, const int32_t* t_aln, const int32_t* t_qb,
    const int32_t* t_qe, const uint8_t* t_type, int64_t n_rows,
    const uint8_t* abuf, const int64_t* aoff) {
    auto* R = new TileJobs();
    R->flag.assign(n_reg, 0);
    R->cons_off.assign(n_reg + 1, 0);
    R->job_ext_off.push_back(0);
    R->ext_off.push_back(0);
    // group table rows per window (stable counting sort by windex
    // keeps the (alignment, emission) add order within each window)
    std::vector<int64_t> wcnt(n_reg + 1, 0);
    for (int64_t r = 0; r < n_rows; ++r) ++wcnt[t_windex[r] + 1];
    for (int64_t i = 0; i < n_reg; ++i) wcnt[i + 1] += wcnt[i];
    std::vector<int64_t> rows(n_rows);
    {
        std::vector<int64_t> cur(wcnt.begin(), wcnt.end() - 1);
        for (int64_t r = 0; r < n_rows; ++r)
            rows[cur[t_windex[r]]++] = r;
    }
    std::vector<std::vector<uint8_t>> estore;  // per-window ext bytes
    std::vector<int32_t> elen;
    std::vector<int8_t> emode;  // mode of entry
    std::vector<int8_t> ehead, etail;  // marker flags per entry
    std::vector<int32_t> ew;
    std::vector<uint8_t> rowbuf;  // unpack scratch for one arm slice
    auto emit_direct = [&](int64_t wi, const uint8_t* p, int64_t len,
                           bool ascii_from_codes) {
        R->flag[wi] = 1;
        for (int64_t i = 0; i < len; ++i) {
            uint8_t c = p[i];
            R->cons_buf.push_back(ascii_from_codes
                                      ? (uint8_t)"ACGTN"[c < 4 ? c : 4]
                                      : c);
        }
    };
    for (int64_t wi = 0; wi < n_reg; ++wi) {
        R->cons_off[wi] = (int64_t)R->cons_buf.size();
        if (!wflag[wi]) continue;
        const int64_t r0 = wcnt[wi], r1 = wcnt[wi + 1];
        const uint8_t* draft = ctg_codes + reg_starts[wi];
        const int64_t dlen = reg_starts[wi + 1] - reg_starts[wi];
        int64_t ni = 0, npre = 0, nsuf = 0, nempty = 0, n_int_rows = 0;
        const bool presuf = use_presuf[wi] != 0;
        for (int64_t j = r0; j < r1; ++j) {
            const uint8_t t = t_type[rows[j]];
            if (t == 3) ++nempty;
            else if (t == 0) { ++ni; ++n_int_rows; }
            else if (t == 1) { if (presuf) ++npre; }
            else if (t == 2) { if (presuf) ++nsuf; }
        }
        const int64_t non_empty = ni + npre + nsuf;
        if (nempty > non_empty) {       // deletion wins (Window.cpp:47)
            R->flag[wi] = 1;            // empty consensus
            continue;
        }
        if (non_empty < 2) {            // too little evidence -> draft
            emit_direct(wi, draft, dlen, true);
            continue;
        }
        // build the marker-flanked sequence list (order of
        // DeviceConsensusRunner._build_job)
        estore.clear(); elen.clear(); emode.clear();
        ehead.clear(); etail.clear(); ew.clear();
        bool arms_added = false, bad = false;
        auto push = [&](const uint8_t* p, int64_t len, int8_t mode,
                        bool head, bool tail) {
            // dedup against existing entries (first occurrence wins)
            for (size_t e = 0; e < estore.size(); ++e) {
                if (emode[e] != mode || elen[e] != (int32_t)len ||
                    ehead[e] != (int8_t)head || etail[e] != (int8_t)tail)
                    continue;
                if (std::memcmp(estore[e].data(), p, (size_t)len) == 0) {
                    ++ew[e];
                    return;
                }
            }
            for (int64_t i = 0; i < len; ++i)
                if (p[i] > 3) { bad = true; return; }
            estore.emplace_back(p, p + len);
            elen.push_back((int32_t)len);
            emode.push_back(mode);
            ehead.push_back(head); etail.push_back(tail);
            ew.push_back(1);
        };
        auto push_row = [&](int64_t r, int8_t mode, bool head,
                            bool tail) {
            const int64_t len = t_qe[r] - t_qb[r];
            unpack2_into(abuf, aoff[t_aln[r]] + t_qb[r], len, rowbuf);
            push(rowbuf.data(), len, mode, head, tail);
        };
        if (n_int_rows == 0)
            push(draft, dlen, M_NW, true, true);
        for (int64_t j = r0; j < r1 && !bad; ++j) {
            const int64_t r = rows[j];
            if (t_type[r] != 0) continue;
            if (t_qe[r] == t_qb[r]) continue;
            push_row(r, M_NW, true, true);
            arms_added = true;
        }
        if (presuf) {   // prefix arms in REVERSE add order
            for (int64_t j = r1 - 1; j >= r0 && !bad; --j) {
                const int64_t r = rows[j];
                if (t_type[r] != 1) continue;
                if (t_qe[r] == t_qb[r]) continue;
                push_row(r, M_LOV, true, false);
                arms_added = true;
            }
            for (int64_t j = r0; j < r1 && !bad; ++j) {
                const int64_t r = rows[j];
                if (t_type[r] != 2) continue;
                if (t_qe[r] == t_qb[r]) continue;
                push_row(r, M_ROV, false, true);
                arms_added = true;
            }
        }
        if (bad) { R->flag[wi] = 3; continue; }  // N in arm/draft
        if (!arms_added) {
            emit_direct(wi, draft, dlen, true);
            continue;
        }
        if (estore.size() == 1 && emode[0] == M_NW) {
            // trivial: single distinct NW sequence IS the consensus
            // (chain graph; markers stripped for short windows)
            emit_direct(wi, estore[0].data(), elen[0], true);
            continue;
        }
        // a device job
        R->flag[wi] = 2;
        R->job_windex.push_back(wi);
        R->job_next.push_back((int32_t)estore.size());
        int32_t maxlen = 0;
        for (size_t e = 0; e < estore.size(); ++e) {
            const int32_t full = elen[e] + ehead[e] + etail[e];
            maxlen = std::max(maxlen, full);
            if (ehead[e]) R->ext_buf.push_back(G_J);
            for (int32_t i = 0; i < elen[e]; ++i)
                R->ext_buf.push_back((int8_t)estore[e][i]);
            if (etail[e]) R->ext_buf.push_back(G_O);
            R->ext_len.push_back(full);
            R->ext_mode.push_back(emode[e]);
            R->ext_w.push_back(ew[e]);
            R->ext_off.push_back((int64_t)R->ext_buf.size());
        }
        R->job_maxlen.push_back(maxlen);
        R->job_ext_off.push_back((int64_t)R->ext_len.size());
    }
    R->cons_off[n_reg] = (int64_t)R->cons_buf.size();
    return R;
}

int64_t hypo_tile_njobs(void* h) {
    return (int64_t)((TileJobs*)h)->job_windex.size();
}
int64_t hypo_tile_next(void* h) {
    return (int64_t)((TileJobs*)h)->ext_len.size();
}
int64_t hypo_tile_cons_len(void* h) {
    return (int64_t)((TileJobs*)h)->cons_buf.size();
}
const uint8_t* hypo_tile_flag(void* h) { return ((TileJobs*)h)->flag.data(); }
const int64_t* hypo_tile_cons_off(void* h) { return ((TileJobs*)h)->cons_off.data(); }
const uint8_t* hypo_tile_cons_buf(void* h) { return ((TileJobs*)h)->cons_buf.data(); }
const int64_t* hypo_tile_job_windex(void* h) { return ((TileJobs*)h)->job_windex.data(); }
const int32_t* hypo_tile_job_next(void* h) { return ((TileJobs*)h)->job_next.data(); }
const int32_t* hypo_tile_job_maxlen(void* h) { return ((TileJobs*)h)->job_maxlen.data(); }
const int64_t* hypo_tile_job_ext_off(void* h) { return ((TileJobs*)h)->job_ext_off.data(); }
const int32_t* hypo_tile_ext_len(void* h) { return ((TileJobs*)h)->ext_len.data(); }
const int8_t* hypo_tile_ext_mode(void* h) { return ((TileJobs*)h)->ext_mode.data(); }
const int32_t* hypo_tile_ext_w(void* h) { return ((TileJobs*)h)->ext_w.data(); }
const int64_t* hypo_tile_ext_off(void* h) { return ((TileJobs*)h)->ext_off.data(); }
const int8_t* hypo_tile_ext_buf(void* h) { return ((TileJobs*)h)->ext_buf.data(); }
void hypo_tile_jobs_free(void* h) { delete (TileJobs*)h; }

// Pack one tile from jobs order[lo:] (already sorted by
// (-n_ext, -maxlen) within the class).  Mirrors _take_tile +
// _dispatch_tile: take jobs while the window count < B and the
// deduplicated arm pool fits A.  Returns hi.  Outputs must be sized
// pool [A*L] (zeroed here), plen [A], idxt [B*K] (-1 filled), amode
// [B*K], aw [B*K], narms [B], th_out [B], row_of [<=B].
int64_t hypo_tile_pack(
    const int64_t* order, int64_t lo, int64_t njobs,
    const int32_t* job_next, const int64_t* job_ext_off,
    const int32_t* ext_len, const int8_t* ext_mode, const int32_t* ext_w,
    const int64_t* ext_off, const int8_t* ext_buf,
    const int32_t* job_th,
    int B, int K, int64_t A, int L, int ndev,
    int8_t* pool, int32_t* plen, int32_t* idxt, int8_t* amode,
    int32_t* aw, int32_t* narms, int32_t* th_out, int32_t* row_of) {
    std::memset(pool, 0, (size_t)(A * L));
    std::memset(plen, 0, sizeof(int32_t) * (size_t)A);
    for (int64_t i = 0; i < (int64_t)B * K; ++i) idxt[i] = -1;
    std::memset(amode, 0, (size_t)B * K);
    std::memset(aw, 0, sizeof(int32_t) * (size_t)B * K);
    std::memset(narms, 0, sizeof(int32_t) * B);
    std::memset(th_out, 0, sizeof(int32_t) * B);
    // arm-pool dedup across windows: open-addressing hash of
    // (len, bytes) -> pool row
    const size_t hsize = 4 * (size_t)A;
    std::vector<int32_t> htab(hsize, -1);
    auto hashof = [&](const int8_t* p, int32_t len) -> uint64_t {
        uint64_t hv = 1469598103934665603ULL ^ (uint64_t)len;
        for (int32_t i = 0; i < len; ++i)
            hv = (hv ^ (uint8_t)p[i]) * 1099511628211ULL;
        return hv;
    };
    int64_t pool_used = 0;
    int64_t hi = lo;
    const int blk = ndev > 1 ? B / ndev : B;
    while (hi < njobs && hi - lo < B) {
        const int64_t j = order[hi];
        // count NEW pool entries this job needs
        int64_t need = 0;
        for (int64_t e = job_ext_off[j]; e < job_ext_off[j + 1]; ++e) {
            const int8_t* p = ext_buf + ext_off[e];
            const int32_t len = ext_len[e];
            uint64_t hv = hashof(p, len) % hsize;
            bool found = false;
            while (htab[hv] >= 0) {
                const int32_t row = htab[hv];
                if (plen[row] == len &&
                    std::memcmp(pool + (int64_t)row * L, p,
                                (size_t)len) == 0) {
                    found = true;
                    break;
                }
                hv = (hv + 1) % hsize;
            }
            if (!found) ++need;
        }
        if (pool_used + need > A) break;
        // commit: insert new pool rows + fill the window row
        const int64_t t = hi - lo;
        const int b = ndev > 1 ? (int)((t % ndev) * blk + t / ndev)
                               : (int)t;
        row_of[t] = b;
        narms[b] = job_next[j];
        th_out[b] = job_th[j];
        int kk = 0;
        for (int64_t e = job_ext_off[j]; e < job_ext_off[j + 1];
             ++e, ++kk) {
            const int8_t* p = ext_buf + ext_off[e];
            const int32_t len = ext_len[e];
            uint64_t hv = hashof(p, len) % hsize;
            int32_t row = -1;
            while (htab[hv] >= 0) {
                const int32_t r2 = htab[hv];
                if (plen[r2] == len &&
                    std::memcmp(pool + (int64_t)r2 * L, p,
                                (size_t)len) == 0) {
                    row = r2;
                    break;
                }
                hv = (hv + 1) % hsize;
            }
            if (row < 0) {
                row = (int32_t)pool_used++;
                std::memcpy(pool + (int64_t)row * L, p, (size_t)len);
                plen[row] = len;
                htab[hv] = row;
            }
            idxt[(int64_t)b * K + kk] = row;
            amode[(int64_t)b * K + kk] = ext_mode[e];
            aw[(int64_t)b * K + kk] = ext_w[e];
        }
        ++hi;
    }
    return hi;
}

// Banded Levenshtein distance (QV evaluation, hypo_tpu/eval_qv.py).
// Same semantics as utils.alnutil.edit_distance: diagonal band of
// half-width `band` around j - i = 0..(m-n); INF outside.  The Python
// twin loops 1e8 rows at chromosome scale; this runs the identical DP
// at memory speed.  a must be the SHORTER sequence (caller swaps).
int64_t hypo_edit_distance_banded(
    const uint8_t* a, int64_t n, const uint8_t* b, int64_t m,
    int64_t band) {
    const int64_t INF = int64_t(1) << 40;
    const int64_t W = 2 * band + 1;
    std::vector<int64_t> prev(W, INF), cur(W, INF);
    for (int64_t k = band; k < W; ++k) prev[k] = k - band;  // row 0
    for (int64_t i = 1; i <= n; ++i) {
        const int64_t lo = std::max<int64_t>(0, i - band);
        const int64_t hi = std::min<int64_t>(m, i + band);
        std::fill(cur.begin(), cur.end(), INF);
        int64_t run = INF;  // the "left" in-row propagation
        for (int64_t j = lo; j <= hi; ++j) {
            const int64_t k = j - i + band;
            int64_t v;
            if (j == 0) {
                v = i;
            } else {
                const int64_t sub = (b[j - 1] != a[i - 1]) ? 1 : 0;
                int64_t best = prev[k] + sub;            // diag
                if (k + 1 < W && prev[k + 1] < INF)
                    best = std::min(best, prev[k + 1] + 1);  // up
                v = best;
            }
            if (run < INF) v = std::min(v, run + 1);      // left
            cur[k] = v;
            run = v;
        }
        std::swap(prev, cur);
    }
    return prev[m - n + band];
}

// Unpack the device tile output (nibble-packed consensus rows, layout
// of device_full._finish_packed) into per-job ASCII.  kind 0 = short
// (strip the J/O marker columns).  out is [cnt * outcap]; out_len[t]
// = -1 flags a capacity overflow row (host fallback).
void hypo_tile_finalize(
    const int8_t* packed, int B, int rowlen,
    const int32_t* row_of, int64_t cnt, int kind,
    uint8_t* out, int64_t outcap, int32_t* out_len) {
    const int half = rowlen - 4;
    for (int64_t t = 0; t < cnt; ++t) {
        const int8_t* row = packed + (int64_t)row_of[t] * rowlen;
        const int ovf = row[half + 2];
        if (ovf) { out_len[t] = -1; continue; }
        int clen = (uint8_t)row[half] | ((uint8_t)row[half + 1] << 8);
        uint8_t* dst = out + t * outcap;
        int o = 0;
        const int beg = (kind == 0) ? 1 : 0;
        const int end = (kind == 0) ? clen - 1 : clen;
        for (int i = beg; i < end && o < outcap; ++i) {
            const uint8_t nib = (i & 1) ? ((uint8_t)row[i >> 1] >> 4)
                                        : ((uint8_t)row[i >> 1] & 0xF);
            dst[o++] = (uint8_t)G_ALPHA[nib < 6 ? nib : 0];
        }
        out_len[t] = o;
    }
}

}  // extern "C"
