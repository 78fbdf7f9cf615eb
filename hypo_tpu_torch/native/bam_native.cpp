// Copied from hypo_tpu/native/bam_native.cpp.
// Native streaming BAM reader + alignment preparation.
//
// Replaces the Python BGZF/record parser (hypo_tpu/io/bam.py) and the
// per-record Alignment construction (hypo_tpu/pipeline/alignment.py
// from_record; reference src/Alignment.cpp:29-63,514-571) for the hot
// path.  The reader is a stateful handle: hypo_bam_read_until() parses
// records while tid < final_tid (one-record lookahead retained across
// calls, mirroring the contig-sorted batch boundary rule of reference
// src/Hypo.cpp:320-322) and leaves flat arrays accessible via getters.
//
// Record-level work done here so Python never touches bytes:
//   - BGZF block inflate (zlib raw deflate, BC extra-field sizes)
//   - flag filter (caller mask) and mapq threshold
//   - rb/re/qab/qae from the CIGAR walk with soft/hard-clip trimming
//   - 4-bit nibble seq -> 2-bit codes, reads with N dropped (invalid)
//   - NM aux tag scan + normalized-edit-distance gate (long reads)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -march=native ... -lz
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr int OP_S = 4, OP_H = 5;
// consumes-query bit 1, consumes-ref bit 2, per BAM op 0..8 (MIDNSHP=X)
constexpr int kConsumes[9] = {3, 1, 2, 2, 1, 0, 0, 3, 3};

struct BamReader {
    FILE* f = nullptr;
    std::vector<uint8_t> zbuf;      // compressed block scratch
    std::vector<uint8_t> dbuf;      // inflated stream buffer (tail kept)
    size_t dpos = 0;                // consume offset into dbuf
    bool eof = false;
    std::string err;

    // header
    std::vector<std::string> ref_names;
    std::vector<int64_t> ref_lens;

    // one-record lookahead (raw record bytes)
    std::vector<uint8_t> pending;
    bool has_pending = false;

    // current batch results (valid alignments)
    std::vector<int32_t> tid, flag, mapq, nm;
    std::vector<int64_t> rb, re;
    std::vector<int64_t> cig_off;   // ncig+1 offsets
    std::vector<uint32_t> cig;      // BAM-encoded (len<<4|op)
    std::vector<int64_t> seq_off;   // nseq+1 offsets IN BASES
    std::vector<uint8_t> seq;       // 2-BIT PACKED trimmed codes
                                    // (base i at bits (i&3)*2 of
                                    // byte i>>2; PackedSeq.hpp:80)
    int64_t seq_bases = 0;          // total bases packed so far
    int64_t n_invalid = 0;          // dropped (N-containing / NM gate)
    int64_t n_filtered = 0;         // flag/mapq filtered

    bool fill(size_t need);
    bool read_block();
    bool next_record(std::vector<uint8_t>& rec);
};

const uint8_t kNib2Code[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                               3, 4, 4, 4, 4, 4, 4, 4};

// BGZF blocks are independent deflate streams, so a batch of them
// inflates in parallel (the htslib role of its decompression thread
// pool): headers are scanned sequentially (cheap), payloads land in
// one compressed scratch, and an OpenMP loop inflates every block
// into its precomputed slice of dbuf.
bool BamReader::read_block() {
    struct Meta { size_t zoff; int clen; uint32_t isize; };
    constexpr int kBatch = 48;      // 48 x 64KB ~ 3 MB per refill
    std::vector<Meta> metas;
    zbuf.clear();
    uint8_t hdr[12];
    std::vector<uint8_t> extra;
    while ((int)metas.size() < kBatch) {
        if (fread(hdr, 1, 12, f) != 12) { eof = true; break; }
        if (hdr[0] != 0x1f || hdr[1] != 0x8b) { err = "bad gzip magic"; return false; }
        const int xlen = hdr[10] | (hdr[11] << 8);
        extra.resize(xlen);
        if ((int)fread(extra.data(), 1, xlen, f) != xlen) { err = "truncated extra"; return false; }
        int bsize = -1;
        for (int o = 0; o + 4 <= xlen;) {
            const int si1 = extra[o], si2 = extra[o + 1];
            const int slen = extra[o + 2] | (extra[o + 3] << 8);
            if (si1 == 'B' && si2 == 'C' && slen == 2)
                bsize = (extra[o + 4] | (extra[o + 5] << 8)) + 1;
            o += 4 + slen;
        }
        if (bsize < 0) { err = "missing BC subfield (not BGZF)"; return false; }
        const int cdata_len = bsize - 12 - xlen - 8;
        const size_t zoff = zbuf.size();
        zbuf.resize(zoff + cdata_len + 8);
        if ((int)fread(zbuf.data() + zoff, 1, cdata_len + 8, f) != cdata_len + 8) {
            err = "truncated block"; return false;
        }
        uint32_t isize;
        memcpy(&isize, zbuf.data() + zoff + cdata_len + 4, 4);
        if (isize > 0) metas.push_back({zoff, cdata_len, isize});
    }
    if (metas.empty()) return true;  // pure EOF / marker blocks
    // drop consumed prefix of dbuf occasionally
    if (dpos > (1 << 20)) {
        dbuf.erase(dbuf.begin(), dbuf.begin() + dpos);
        dpos = 0;
    }
    const size_t old = dbuf.size();
    std::vector<size_t> doff(metas.size() + 1, 0);
    for (size_t i = 0; i < metas.size(); ++i)
        doff[i + 1] = doff[i] + metas[i].isize;
    dbuf.resize(old + doff.back());
    bool ok = true;
    #pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < (int)metas.size(); ++i) {
        z_stream zs{};
        inflateInit2(&zs, -15);
        zs.next_in = zbuf.data() + metas[i].zoff;
        zs.avail_in = metas[i].clen;
        zs.next_out = dbuf.data() + old + doff[i];
        zs.avail_out = metas[i].isize;
        const int rc = inflate(&zs, Z_FINISH);
        inflateEnd(&zs);
        if (rc != Z_STREAM_END) ok = false;
    }
    if (!ok) { err = "inflate failed"; return false; }
    return true;
}

bool BamReader::fill(size_t need) {
    while (dbuf.size() - dpos < need) {
        if (eof) return false;
        if (!read_block()) return false;
    }
    return true;
}

bool BamReader::next_record(std::vector<uint8_t>& rec) {
    if (!fill(4)) return false;
    int32_t block_size;
    memcpy(&block_size, dbuf.data() + dpos, 4);
    dpos += 4;
    if (block_size <= 0 || !fill((size_t)block_size)) return false;
    rec.assign(dbuf.begin() + dpos, dbuf.begin() + dpos + block_size);
    dpos += block_size;
    return true;
}

int parse_nm(const uint8_t* d, size_t off, size_t n) {
    while (off + 3 <= n) {
        const char t0 = d[off], t1 = d[off + 1], typ = d[off + 2];
        off += 3;
        int64_t val = 0;
        int width = 0;
        switch (typ) {
            case 'A': case 'C': val = d[off]; width = 1; break;
            case 'c': val = (int8_t)d[off]; width = 1; break;
            case 's': { int16_t v; memcpy(&v, d + off, 2); val = v; width = 2; break; }
            case 'S': { uint16_t v; memcpy(&v, d + off, 2); val = v; width = 2; break; }
            case 'i': { int32_t v; memcpy(&v, d + off, 4); val = v; width = 4; break; }
            case 'I': { uint32_t v; memcpy(&v, d + off, 4); val = v; width = 4; break; }
            case 'f': width = 4; break;
            case 'Z': case 'H': {
                size_t e = off;
                while (e < n && d[e]) ++e;
                off = e + 1;
                width = -1;
                break;
            }
            case 'B': {
                const char sub = d[off];
                int32_t cnt;
                memcpy(&cnt, d + off + 1, 4);
                int esz = (sub == 'c' || sub == 'C') ? 1
                          : (sub == 's' || sub == 'S') ? 2 : 4;
                off += 5 + (size_t)cnt * esz;
                width = -1;
                break;
            }
            default: return -1;
        }
        if (width > 0) off += width;
        if (t0 == 'N' && t1 == 'M' &&
            (typ == 'c' || typ == 'C' || typ == 's' || typ == 'S' ||
             typ == 'i' || typ == 'I'))
            return (int)val;
    }
    return -1;
}

}  // namespace

extern "C" {

void* hypo_bam_open(const char* path) {
    auto* r = new BamReader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    // magic + header text
    if (!r->fill(12)) { fclose(r->f); delete r; return nullptr; }
    if (memcmp(r->dbuf.data() + r->dpos, "BAM\x01", 4) != 0) {
        fclose(r->f); delete r; return nullptr;
    }
    r->dpos += 4;
    int32_t l_text;
    memcpy(&l_text, r->dbuf.data() + r->dpos, 4);
    r->dpos += 4;
    if (!r->fill(l_text + 4)) { fclose(r->f); delete r; return nullptr; }
    r->dpos += l_text;
    int32_t n_ref;
    memcpy(&n_ref, r->dbuf.data() + r->dpos, 4);
    r->dpos += 4;
    for (int i = 0; i < n_ref; ++i) {
        if (!r->fill(8)) { fclose(r->f); delete r; return nullptr; }
        int32_t l_name;
        memcpy(&l_name, r->dbuf.data() + r->dpos, 4);
        r->dpos += 4;
        if (!r->fill(l_name + 4)) { fclose(r->f); delete r; return nullptr; }
        r->ref_names.emplace_back(
            (const char*)r->dbuf.data() + r->dpos, (size_t)l_name - 1);
        r->dpos += l_name;
        int32_t l_ref;
        memcpy(&l_ref, r->dbuf.data() + r->dpos, 4);
        r->dpos += 4;
        r->ref_lens.push_back(l_ref);
    }
    return r;
}

void hypo_bam_close(void* h) {
    auto* r = (BamReader*)h;
    if (r->f) fclose(r->f);
    delete r;
}

int hypo_bam_nrefs(void* h) { return (int)((BamReader*)h)->ref_names.size(); }

int hypo_bam_ref_name(void* h, int i, char* buf, int buflen) {
    const auto& s = ((BamReader*)h)->ref_names[i];
    const int n = (int)s.size() < buflen - 1 ? (int)s.size() : buflen - 1;
    memcpy(buf, s.data(), n);
    buf[n] = 0;
    return (int)s.size();
}

int64_t hypo_bam_ref_len(void* h, int i) {
    return ((BamReader*)h)->ref_lens[i];
}

// Parse records while tid < final_tid.  Returns number of valid
// alignments materialized, or -1 on stream error.  norm_edit_th < 0
// disables the NM gate (short-read mode).
int64_t hypo_bam_read_until(void* h, int final_tid, int flag_exclude,
                            int min_mapq, int norm_edit_th) {
    auto* r = (BamReader*)h;
    r->tid.clear(); r->flag.clear(); r->mapq.clear(); r->nm.clear();
    r->rb.clear(); r->re.clear();
    r->cig_off.assign(1, 0); r->cig.clear();
    r->seq_off.assign(1, 0); r->seq.clear(); r->seq_bases = 0;
    r->n_invalid = 0;
    r->n_filtered = 0;

    std::vector<uint8_t> rec;
    std::vector<uint8_t> codes;
    for (;;) {
        if (r->has_pending) {
            rec = r->pending;
            r->has_pending = false;
        } else if (!r->next_record(rec)) {
            if (!r->err.empty()) return -1;
            break;  // clean EOF
        }
        int32_t refid, pos;
        memcpy(&refid, rec.data(), 4);
        memcpy(&pos, rec.data() + 4, 4);
        const int l_read_name = rec[8];
        const int mq = rec[9];
        uint16_t n_cigar, fl;
        memcpy(&n_cigar, rec.data() + 12, 2);
        memcpy(&fl, rec.data() + 14, 2);
        int32_t l_seq;
        memcpy(&l_seq, rec.data() + 16, 4);
        // only records that would survive the flag filter may trigger the
        // batch boundary (parity with pipeline/polish.py records_until)
        if (refid >= final_tid && !(fl & flag_exclude)) {
            r->pending = rec;
            r->has_pending = true;
            break;
        }
        if (fl & flag_exclude) { ++r->n_filtered; continue; }
        if (refid < 0) { ++r->n_filtered; continue; }
        if (mq < min_mapq) { ++r->n_filtered; continue; }

        size_t off = 32 + l_read_name;
        const uint32_t* cg = (const uint32_t*)(rec.data() + off);
        off += 4ull * n_cigar;
        const uint8_t* packed = rec.data() + off;
        off += (l_seq + 1) / 2;
        off += l_seq;  // qual
        const int nmv = parse_nm(rec.data(), off, rec.size());

        // CIGAR walk: rb/re/qab/qae
        int64_t ref_span = 0, q_len = 0;
        for (int i = 0; i < n_cigar; ++i) {
            const int op = cg[i] & 0xF;
            const int64_t ln = cg[i] >> 4;
            if (op < 9) {
                if (kConsumes[op] & 2) ref_span += ln;
                if (kConsumes[op] & 1) q_len += ln;
            }
        }
        int64_t qab = 0;
        {
            int i = 0;
            while (i < n_cigar &&
                   ((cg[i] & 0xF) == OP_S || (cg[i] & 0xF) == OP_H)) {
                if ((cg[i] & 0xF) == OP_S) qab += cg[i] >> 4;
                ++i;
            }
        }
        int64_t trailing = 0;
        for (int i = n_cigar - 1; i >= 0; --i) {
            const int op = cg[i] & 0xF;
            if (op == OP_H) continue;
            if (op == OP_S) { trailing += cg[i] >> 4; continue; }
            break;
        }
        const int64_t qae = q_len - trailing;
        const int64_t arb = pos, are = pos + ref_span;
        if (norm_edit_th >= 0 && nmv >= 0) {
            const int64_t rlen = are - arb;
            if (rlen > 0 && ((int64_t)nmv * 100) / rlen > norm_edit_th) {
                ++r->n_invalid;
                continue;
            }
        }
        // unpack + trim seq, drop on N
        codes.resize(qae - qab);
        bool has_n = false;
        for (int64_t j = qab; j < qae; ++j) {
            const uint8_t nib = (j & 1) ? (packed[j >> 1] & 0xF)
                                        : (packed[j >> 1] >> 4);
            const uint8_t c = kNib2Code[nib];
            if (c > 3) { has_n = true; break; }
            codes[j - qab] = c;
        }
        if (has_n) { ++r->n_invalid; continue; }

        r->tid.push_back(refid);
        r->flag.push_back(fl);
        r->mapq.push_back(mq);
        r->nm.push_back(nmv);
        r->rb.push_back(arb);
        r->re.push_back(are);
        r->cig.insert(r->cig.end(), cg, cg + n_cigar);
        r->cig_off.push_back((int64_t)r->cig.size());
        for (const uint8_t c : codes) {
            const int64_t b = r->seq_bases++;
            if ((b & 3) == 0) r->seq.push_back(0);
            r->seq[b >> 2] |= (uint8_t)(c << ((b & 3) << 1));
        }
        r->seq_off.push_back(r->seq_bases);
    }
    return (int64_t)r->tid.size();
}

int64_t hypo_bam_n_invalid(void* h) { return ((BamReader*)h)->n_invalid; }
int64_t hypo_bam_n_filtered(void* h) { return ((BamReader*)h)->n_filtered; }
const int32_t* hypo_bam_get_tid(void* h) { return ((BamReader*)h)->tid.data(); }
const int32_t* hypo_bam_get_flag(void* h) { return ((BamReader*)h)->flag.data(); }
const int32_t* hypo_bam_get_mapq(void* h) { return ((BamReader*)h)->mapq.data(); }
const int32_t* hypo_bam_get_nm(void* h) { return ((BamReader*)h)->nm.data(); }
const int64_t* hypo_bam_get_rb(void* h) { return ((BamReader*)h)->rb.data(); }
const int64_t* hypo_bam_get_re(void* h) { return ((BamReader*)h)->re.data(); }
const int64_t* hypo_bam_get_cig_off(void* h) { return ((BamReader*)h)->cig_off.data(); }
const uint32_t* hypo_bam_get_cig(void* h) { return ((BamReader*)h)->cig.data(); }
const int64_t* hypo_bam_get_seq_off(void* h) { return ((BamReader*)h)->seq_off.data(); }
const uint8_t* hypo_bam_get_seq(void* h) { return ((BamReader*)h)->seq.data(); }

}  // extern "C"
