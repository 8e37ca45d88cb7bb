// Native BAM/BGZF batch decoder for aletsch-tpu.
//
// Replaces the htslib usage of the reference (hit construction,
// rnacore/hit.cc; region-seeked scans, meta/generator.cc) with a small
// zlib-based decoder exposed through a C ABI consumed via ctypes.  Records
// decode in batches into flat arrays: fixed int32 fields per record plus
// packed cigar and qname pools, so the Python side does no byte-level
// parsing on the hot path.
//
// Virtual offsets follow the BGZF convention (coffset << 16 | uoffset).
//
// Build: g++ -O2 -shared -fPIC -o libabam.so abam.cpp -lz

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

struct Target {
    std::string name;
    int64_t len;
};

struct BamFile {
    FILE* fp = nullptr;
    // current decompressed block
    std::vector<uint8_t> buf;
    size_t pos = 0;            // cursor within buf
    int64_t block_start = 0;   // compressed offset of current block
    bool eof = false;
    std::vector<Target> targets;
    std::string text;
    std::vector<uint8_t> scratch;
};

bool load_block(BamFile* f) {
    f->block_start = ftello(f->fp);
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f->fp) < 12) { f->buf.clear(); f->pos = 0; f->eof = true; return false; }
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) { f->eof = true; return false; }
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f->fp) < xlen) { f->eof = true; return false; }
    int bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
        uint8_t si1 = extra[i], si2 = extra[i + 1];
        uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
        if (si1 == 0x42 && si2 == 0x43 && slen == 2)
            bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        i += 4 + slen;
    }
    if (bsize < 0) { f->eof = true; return false; }
    int cdata_len = bsize - 12 - xlen - 8;
    f->scratch.resize(cdata_len > 0 ? cdata_len : 0);
    if (cdata_len > 0 && (int)fread(f->scratch.data(), 1, cdata_len, f->fp) < cdata_len) {
        f->eof = true; return false;
    }
    uint8_t tail[8];
    if (fread(tail, 1, 8, f->fp) < 8) { f->eof = true; return false; }
    uint32_t isize = tail[4] | (tail[5] << 8) | (tail[6] << 16) | ((uint32_t)tail[7] << 24);
    f->buf.resize(isize);
    f->pos = 0;
    if (isize == 0) return true;   // EOF marker block: keep reading next
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, -15);
    zs.next_in = f->scratch.data();
    zs.avail_in = cdata_len;
    zs.next_out = f->buf.data();
    zs.avail_out = isize;
    int r = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (r != Z_STREAM_END) { f->eof = true; return false; }
    return true;
}

// read n bytes across blocks; returns bytes read
size_t bread(BamFile* f, uint8_t* out, size_t n) {
    size_t got = 0;
    while (got < n) {
        if (f->pos >= f->buf.size()) {
            if (f->eof || !load_block(f)) break;
            if (f->buf.empty()) {
                // zero-length block (EOF marker); try next, stop at file end
                if (feof(f->fp)) break;
                continue;
            }
        }
        size_t take = f->buf.size() - f->pos;
        if (take > n - got) take = n - got;
        memcpy(out + got, f->buf.data() + f->pos, take);
        f->pos += take;
        got += take;
    }
    return got;
}

int32_t rd32(const uint8_t* p) {
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}

}  // namespace

extern "C" {

BamFile* abam_open(const char* path) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    BamFile* f = new BamFile();
    f->fp = fp;
    if (!load_block(f)) { delete f; fclose(fp); return nullptr; }
    uint8_t magic[4];
    if (bread(f, magic, 4) < 4 || memcmp(magic, "BAM\x01", 4) != 0) {
        fclose(fp); delete f; return nullptr;
    }
    uint8_t b4[4];
    bread(f, b4, 4);
    int32_t l_text = rd32(b4);
    f->text.resize(l_text);
    bread(f, (uint8_t*)f->text.data(), l_text);
    bread(f, b4, 4);
    int32_t n_ref = rd32(b4);
    for (int i = 0; i < n_ref; i++) {
        bread(f, b4, 4);
        int32_t l_name = rd32(b4);
        std::string nm(l_name, '\0');
        bread(f, (uint8_t*)nm.data(), l_name);
        nm.resize(l_name - 1);
        bread(f, b4, 4);
        Target t;
        t.name = nm;
        t.len = rd32(b4);
        f->targets.push_back(t);
    }
    return f;
}

void abam_close(BamFile* f) {
    if (!f) return;
    if (f->fp) fclose(f->fp);
    delete f;
}

int abam_ntargets(BamFile* f) { return (int)f->targets.size(); }

int abam_target_name(BamFile* f, int i, char* out, int cap) {
    const std::string& s = f->targets[i].name;
    int n = (int)s.size() < cap - 1 ? (int)s.size() : cap - 1;
    memcpy(out, s.data(), n);
    out[n] = 0;
    return (int)s.size();
}

int64_t abam_target_len(BamFile* f, int i) { return f->targets[i].len; }

uint64_t abam_tell(BamFile* f) {
    if (f->pos >= f->buf.size()) return ((uint64_t)ftello(f->fp)) << 16;
    return (((uint64_t)f->block_start) << 16) | (uint64_t)f->pos;
}

int abam_seek(BamFile* f, uint64_t voff) {
    int64_t coff = (int64_t)(voff >> 16);
    size_t uoff = (size_t)(voff & 0xFFFF);
    f->eof = false;
    if (fseeko(f->fp, coff, SEEK_SET) != 0) return -1;
    if (!load_block(f)) return -1;
    f->pos = uoff;
    return 0;
}

// fixed layout (per record, 24 int32):
// 0 tid, 1 pos, 2 rpos, 3 mapq, 4 flag, 5 mtid, 6 mpos, 7 isize,
// 8 n_cigar, 9 cigar_off, 10 qname_off, 11 qname_len, 12 xs, 13 hi,
// 14 nh, 15 nm, 16 n_splice, 17 coords_off, 18 m_cnt (match-interval
// pairs), 19 s_cnt (splice coords), 20 i_cnt (indel-interval pairs),
// 21..23 reserved.
//
// coords pool layout per record (int32): m_cnt*2 match-interval bounds,
// then s_cnt splice coordinates (interior N ops), then i_cnt*2
// indel-interval bounds (I -> [p-1,p+1), D -> [s,p)), matching
// hit::extract_splices / bundle_base::add_intervals.
int abam_read_batch(BamFile* f, int maxn, int32_t* fixed, uint64_t* voffs,
                    uint32_t* cigars, int64_t cig_cap,
                    char* qnames, int64_t q_cap,
                    int32_t* coords, int64_t coords_cap) {
    static const int CONSUME_REF =
        (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8);
    int count = 0;
    int64_t cig_off = 0;
    int64_t q_off = 0;
    int64_t c_off = 0;
    std::vector<uint8_t> rec;
    while (count < maxn) {
        uint64_t voff = abam_tell(f);
        uint8_t b4[4];
        if (bread(f, b4, 4) < 4) break;
        int32_t block_size = rd32(b4);
        if (block_size <= 0) break;
        rec.resize(block_size);
        if ((int)bread(f, rec.data(), block_size) < block_size) break;
        const uint8_t* p = rec.data();
        int32_t refID = rd32(p + 0);
        int32_t pos = rd32(p + 4);
        uint8_t l_read_name = p[8];
        uint8_t mapq = p[9];
        uint16_t n_cigar = p[12] | (p[13] << 8);
        uint16_t flag = p[14] | (p[15] << 8);
        int32_t l_seq = rd32(p + 16);
        int32_t next_refID = rd32(p + 20);
        int32_t next_pos = rd32(p + 24);
        int32_t tlen = rd32(p + 28);
        size_t off = 32;
        // capacity check (coords worst case: 5 slots per cigar op)
        if (q_off + l_read_name >= q_cap || cig_off + n_cigar > cig_cap ||
            c_off + 5ll * n_cigar + 4 > coords_cap) {
            // rewind to record start and stop this batch
            abam_seek(f, voff);
            break;
        }
        int32_t* fx = fixed + (int64_t)count * 24;
        voffs[count] = voff;
        fx[0] = refID;
        fx[1] = pos;
        fx[3] = mapq;
        fx[4] = flag;
        fx[5] = next_refID;
        fx[6] = next_pos;
        fx[7] = tlen;
        fx[8] = n_cigar;
        fx[9] = (int32_t)cig_off;
        fx[10] = (int32_t)q_off;
        fx[11] = l_read_name - 1;
        memcpy(qnames + q_off, p + off, l_read_name - 1);
        qnames[q_off + l_read_name - 1] = 0;
        q_off += l_read_name;
        off += l_read_name;
        int32_t ref_len = 0;
        int32_t total_n_ops = 0;
        for (int k = 0; k < n_cigar; k++) {
            uint32_t c;
            memcpy(&c, p + off + 4 * k, 4);
            cigars[cig_off + k] = c;
            int op = c & 0xF;
            if (op == 3) total_n_ops++;
            if ((CONSUME_REF >> op) & 1) ref_len += (int32_t)(c >> 4);
        }
        // second walk: match intervals, interior splices, indel intervals
        {
            int32_t gp = pos;
            int32_t m_cnt = 0, s_cnt = 0, i_cnt = 0;
            int64_t mbase = c_off;
            // match intervals first
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = cigars[cig_off + k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (op == 0) {  // CMATCH
                    coords[mbase + 2 * m_cnt] = gp - ln;
                    coords[mbase + 2 * m_cnt + 1] = gp;
                    m_cnt++;
                }
            }
            int64_t sbase = mbase + 2 * m_cnt;
            gp = pos;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = cigars[cig_off + k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (k == 0 || k == n_cigar - 1) continue;
                if (op != 3) continue;  // CREF_SKIP
                coords[sbase + s_cnt] = gp - ln;
                coords[sbase + s_cnt + 1] = gp;
                s_cnt += 2;
            }
            int64_t ibase = sbase + s_cnt;
            gp = pos;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = cigars[cig_off + k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (op == 1) {  // CINS
                    coords[ibase + 2 * i_cnt] = gp - 1;
                    coords[ibase + 2 * i_cnt + 1] = gp + 1;
                    i_cnt++;
                } else if (op == 2) {  // CDEL
                    coords[ibase + 2 * i_cnt] = gp - ln;
                    coords[ibase + 2 * i_cnt + 1] = gp;
                    i_cnt++;
                }
            }
            fx[16] = s_cnt / 2;
            fx[17] = (int32_t)mbase;
            fx[18] = m_cnt;
            fx[19] = s_cnt;
            fx[20] = i_cnt;
            fx[21] = total_n_ops;
            c_off = ibase + 2 * i_cnt;
        }
        cig_off += n_cigar;
        off += 4ull * n_cigar;
        fx[2] = pos + ref_len;
        off += (l_seq + 1) / 2 + l_seq;
        // aux tags
        int32_t xs = '.', ts = '.', hi = -1, nh = -1, nm = 0;
        while (off + 3 <= (size_t)block_size) {
            char t0 = (char)p[off], t1 = (char)p[off + 1];
            char typ = (char)p[off + 2];
            off += 3;
            int64_t val = 0;
            bool have = false;
            switch (typ) {
                case 'A': val = p[off]; off += 1; have = true; break;
                case 'c': val = (int8_t)p[off]; off += 1; have = true; break;
                case 'C': val = p[off]; off += 1; have = true; break;
                case 's': { int16_t v; memcpy(&v, p + off, 2); val = v; off += 2; have = true; break; }
                case 'S': { uint16_t v; memcpy(&v, p + off, 2); val = v; off += 2; have = true; break; }
                case 'i': { int32_t v; memcpy(&v, p + off, 4); val = v; off += 4; have = true; break; }
                case 'I': { uint32_t v; memcpy(&v, p + off, 4); val = v; off += 4; have = true; break; }
                case 'f': off += 4; break;
                case 'Z': case 'H': {
                    while (off < (size_t)block_size && p[off] != 0) off++;
                    off++;
                    break;
                }
                case 'B': {
                    char sub = (char)p[off];
                    int32_t cnt; memcpy(&cnt, p + off + 1, 4);
                    int sz = (sub == 'c' || sub == 'C') ? 1 :
                             (sub == 's' || sub == 'S') ? 2 : 4;
                    off += 5 + (int64_t)cnt * sz;
                    break;
                }
                default: off = block_size; break;
            }
            if (!have) continue;
            if (t0 == 'X' && t1 == 'S' && typ == 'A') xs = (int32_t)val;
            else if (t0 == 't' && t1 == 's' && typ == 'A') ts = (int32_t)val;
            else if (t0 == 'H' && t1 == 'I') hi = (int32_t)val;
            else if (t0 == 'N' && t1 == 'H') nh = (int32_t)val;
            else if ((t0 == 'N' || t0 == 'n') && (t1 == 'M' || t1 == 'm')) nm = (int32_t)val;
        }
        // ts -> xs conversion (rnacore/hit.cc:116-123)
        if (xs == '.' && ts != '.') {
            bool rev = (flag & 0x10) != 0;
            if (ts == '+') xs = rev ? '-' : '+';
            else if (ts == '-') xs = rev ? '+' : '-';
        }
        fx[12] = xs;
        fx[13] = hi;
        fx[14] = nh;
        fx[15] = nm;
        count++;
    }
    return count;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Region/preview scanner: the record->bundle routing loop of
// meta/generator.cc:51-201 (region mode) and previewer.cc:151-249 (preview
// mode) runs natively.  Records are filtered, strand-routed and split into
// per-strand bundles exactly like the Python batched loops in
// aletsch_tpu/meta/{generator,previewer}.py; each flushed bundle carries its
// own record rows (24 fixed fields + routed strand in slot 22 + hid as a
// 25th int), qname/coords pools, and pre-concatenated match/indel interval
// pair arrays so the Python side builds coverage maps in bulk.

namespace {

struct PendingBundle {
    int32_t tid = -1;
    int64_t lpos = ((int64_t)1) << 40;
    int64_t rpos = 0;
    int32_t last_pos = -1, last_rpos = -1;
    bool has_last = false;
    int32_t n = 0;
    std::vector<int32_t> fixed;     // 25 ints per assignment
    std::vector<char> qnames;
    std::vector<int32_t> coords;
    std::vector<int32_t> mev;       // match-interval pairs
    std::vector<int32_t> iev;       // indel-interval pairs
    void reset() {
        tid = -1; lpos = ((int64_t)1) << 40; rpos = 0;
        last_pos = last_rpos = -1; has_last = false; n = 0;
        fixed.clear(); qnames.clear(); coords.clear();
        mev.clear(); iev.clear();
    }
};

struct FlushedBundle {
    int32_t strand;                 // 0 = '+', 1 = '-'
    int32_t tid;
    int32_t lpos, rpos;
    int32_t epoch;                  // hid counter at flush time: bundles
                                    // flushed by the same record share it
    std::vector<int32_t> fixed;
    std::vector<char> qnames;
    std::vector<int32_t> coords;
    std::vector<int32_t> mev;
    std::vector<int32_t> iev;
    std::vector<int32_t> frgs;      // mate pairs: (h1, h2) per fragment
    std::vector<int32_t> splices;   // sorted unique splice positions
    int32_t xsp = 0, xsm = 0;       // per-hit XS '+' / '-' counts (the
                                    // unstranded strand vote, bundle
                                    // compute_strand)
};

// Python floor-mod (non-negative for positive modulus)
static inline int64_t pymod(int64_t x, int64_t m) {
    int64_t r = x % m;
    return r < 0 ? r + m : r;
}

// bundle_base.cc:267-323 build_fragments, bit-exact with the Python port
// in core/bundle.py (qhash buckets keyed by crc32/pos/isize; first match
// in bucket order wins)
static void pair_fragments(const std::vector<int32_t>& fixed,
                           const std::vector<char>& qnames,
                           std::vector<int32_t>& out) {
    int n = (int)(fixed.size() / 25);
    if (n == 0) return;
    int64_t M = n + 1 < 1000000 ? n + 1 : 1000000;
    // CSR buckets in thread-local scratch: the former per-bucket
    // vector<vector> was ~1 alloc per hit per bundle (the hottest scan
    // symbol).  Two-pass counting keeps ascending-i order within each
    // bucket — identical "first match in bucket order wins" semantics.
    static thread_local std::vector<int32_t> keys, cnt, bucket;
    static thread_local std::vector<char> paired_v;
    keys.resize(n);
    cnt.assign(M + 1, 0);
    bucket.resize(n);
    paired_v.assign(n, 0);
    char* paired = paired_v.data();
    for (int i = 0; i < n; i++) {
        const int32_t* fx = fixed.data() + (size_t)i * 25;
        uint32_t qh = (uint32_t)fx[23];
        int64_t k = pymod(pymod((int64_t)qh, M) + pymod(fx[1], M) +
                          pymod(-(int64_t)fx[7], M), M);
        keys[i] = (int32_t)k;
        cnt[k + 1]++;
    }
    for (int64_t k = 0; k < M; k++) cnt[k + 1] += cnt[k];
    {
        static thread_local std::vector<int32_t> slot;
        slot.assign(cnt.begin(), cnt.end() - 1);
        for (int i = 0; i < n; i++) bucket[slot[keys[i]]++] = i;
    }
    for (int i = 0; i < n; i++) {
        if (paired[i]) continue;
        const int32_t* fx = fixed.data() + (size_t)i * 25;
        uint32_t qh = (uint32_t)fx[23];
        int64_t k = pymod(pymod((int64_t)qh, M) + pymod(fx[6], M) +
                          pymod((int64_t)fx[7], M), M);
        int x = -1;
        for (int32_t b = cnt[k]; b < cnt[k + 1]; b++) {
            int32_t u = bucket[b];
            if (u == i || paired[u]) continue;
            const int32_t* fz = fixed.data() + (size_t)u * 25;
            if (fz[1] != fx[6]) continue;                 // z.pos == h.mpos
            if ((int64_t)fz[7] + fx[7] != 0) continue;    // isize sum 0
            if (strcmp(qnames.data() + fz[10],
                       qnames.data() + fx[10]) != 0) continue;
            x = u;
            break;
        }
        if (x < 0) continue;
        out.push_back(i);
        out.push_back(x);
        paired[i] = 1;
        paired[x] = 1;
    }
}

// strand inference from flags (rnacore/hit.cc:152-185); returns '.', '+', '-'
int32_t strand_of(uint16_t flag, int32_t libtype) {
    bool paired = (flag & 0x1) != 0;
    bool rev = (flag & 0x10) != 0;
    bool r1 = (flag & 0x40) != 0;
    bool r2 = (flag & 0x80) != 0;
    if (libtype == 1) {            // FR_FIRST
        if (!paired) return rev ? '+' : '-';
        if (r1 && !r2) return rev ? '+' : '-';
        if (r2 && !r1) return rev ? '-' : '+';
        return '.';
    }
    if (libtype == 2) {            // FR_SECOND
        if (!paired) return rev ? '-' : '+';
        if (r1 && !r2) return rev ? '-' : '+';
        if (r2 && !r1) return rev ? '+' : '-';
        return '.';
    }
    return '.';
}

}  // namespace

struct Scanner {
    BamFile* f = nullptr;
    // mode + region
    int32_t preview = 0;
    int32_t tid = -1;
    int32_t end1 = 0;
    // filters
    int32_t min_mapq = 0, max_num_cigar = 0, max_read_span = 0;
    int32_t span_quirk = 0;   // ALETSCH_REF_QUIRKS mate-span filter
    int32_t min_bundle_gap = 0;
    int32_t use_second = 0, uniq_only = 0, library_type = 0;
    // state
    PendingBundle bb[2];
    std::vector<FlushedBundle> out;
    int32_t pre_lpos = -1, pre_rpos = -1;
    int32_t hid = 0;
    bool done = false;
    std::vector<uint8_t> rec;
    std::vector<uint32_t> cig;
    // region-boundary tracker piggybacked on the preview scan: the
    // sample_profile region grid (set_batch_boundaries, non-quirks
    // semantics) taps the raw mapped record stream — only the FUNMAP and
    // read-span filters apply, NOT the preview's mapq/cigar/secondary
    // filters — so one decode pass serves both the insert-size preview
    // and the region table (aletsch_tpu/meta/sample_profile.py).
    int64_t brl = 0;               // region partition length; 0 = off
    int32_t btid = -1;
    int64_t brid = 0, brpos = 0;
    std::vector<std::vector<int64_t>> bs1, bs2, be1;
    std::vector<std::vector<uint64_t>> boff;
};

namespace {

void flush_bundle(Scanner* s, int k) {
    PendingBundle& B = s->bb[k];
    if (B.n > 0) {
        FlushedBundle fb;
        fb.strand = k;
        fb.epoch = s->hid;
        pair_fragments(B.fixed, B.qnames, fb.frgs);
        fb.tid = B.tid;
        fb.lpos = (int32_t)B.lpos;
        fb.rpos = (int32_t)B.rpos;
        // sorted-unique splice positions over all hit chains (equals
        // ChainSet.get_splices on the materialized bundle: chain dedup does
        // not change the coordinate set and all counts are live at flush)
        for (size_t j = 0; j * 25 < B.fixed.size(); j++) {
            const int32_t* row = B.fixed.data() + 25 * j;
            if (row[12] == '+') fb.xsp++;
            else if (row[12] == '-') fb.xsm++;
            int32_t sc = row[19];
            if (!sc) continue;
            const int32_t* ch = B.coords.data() + row[17] + 2 * row[18];
            fb.splices.insert(fb.splices.end(), ch, ch + sc);
        }
        std::sort(fb.splices.begin(), fb.splices.end());
        fb.splices.erase(std::unique(fb.splices.begin(), fb.splices.end()),
                         fb.splices.end());
        fb.fixed = std::move(B.fixed);
        fb.qnames = std::move(B.qnames);
        fb.coords = std::move(B.coords);
        fb.mev = std::move(B.mev);
        fb.iev = std::move(B.iev);
        s->out.push_back(std::move(fb));
    }
    B.reset();
}

// append one routed record to bundle k; mirrors BundleBase.add_hit +
// add_hit_parsed (core/bundle.py)
void add_to(Scanner* s, int k, const int32_t* fx24, int32_t strand_char,
            int32_t my_hid, const char* qname, int32_t qlen,
            const int32_t* coords, int32_t clen,
            int32_t m_cnt, int32_t s_cnt, int32_t i_cnt) {
    PendingBundle& B = s->bb[k];
    int32_t pos = fx24[1], rpos = fx24[2], mpos = fx24[6];
    if (B.has_last && B.last_pos == pos && B.last_rpos == rpos)
        return;                    // consecutive duplicate within the bundle
    size_t fb = B.fixed.size();
    B.fixed.resize(fb + 25);
    int32_t* o = B.fixed.data() + fb;
    memcpy(o, fx24, 24 * sizeof(int32_t));
    o[10] = (int32_t)B.qnames.size();      // qname_off relative to pool
    o[17] = (int32_t)B.coords.size();      // coords_off relative to pool
    o[22] = strand_char;
    o[24] = my_hid;
    B.qnames.insert(B.qnames.end(), qname, qname + qlen);
    B.qnames.push_back(0);
    B.coords.insert(B.coords.end(), coords, coords + clen);
    B.mev.insert(B.mev.end(), coords, coords + 2 * m_cnt);
    B.iev.insert(B.iev.end(), coords + 2 * m_cnt + s_cnt,
                 coords + 2 * m_cnt + s_cnt + 2 * i_cnt);
    B.has_last = true;
    B.last_pos = pos;
    B.last_rpos = rpos;
    if (B.tid == -1) B.tid = fx24[0];
    if (pos < B.lpos) B.lpos = pos;
    int64_t p = rpos;
    if (mpos > rpos && mpos <= (int64_t)rpos + 500000) p = mpos;
    if (p > B.rpos) B.rpos = p;
    B.n++;
}

// one raw mapped record for the region-boundary tracker (the serial
// sample_profile._set_batch_boundaries_slow state machine, bit-exact)
void boundary_update(Scanner* s, int32_t tid, int64_t pos, int64_t rpos,
                     uint64_t voff) {
    if (llabs(pos - rpos) >= s->max_read_span) return;
    if (tid != s->btid) {
        if (s->btid >= 0) s->be1[s->btid][s->brid] = s->brpos;
        s->btid = tid;
        s->brid = 0;
        s->bs1[tid][0] = pos;
        s->bs2[tid][0] = rpos;
        s->boff[tid][0] = voff;
        s->brpos = rpos;
    }
    if (pos > s->brpos + s->min_bundle_gap &&
        pos >= s->brl * (1 + s->brid)) {
        s->be1[s->btid][s->brid] = s->brpos;
        s->brid = pos / s->brl;
        s->bs1[s->btid][s->brid] = pos;
        s->bs2[s->btid][s->brid] = rpos;
        s->boff[s->btid][s->brid] = voff;
    }
    if (rpos > s->brpos) s->brpos = rpos;
}

}  // namespace

extern "C" {

Scanner* abam_scan_open(BamFile* f, int32_t preview, int32_t tid,
                        int32_t end1, int32_t min_mapq, int32_t max_num_cigar,
                        int32_t max_read_span, int32_t min_bundle_gap,
                        int32_t use_second, int32_t uniq_only,
                        int32_t library_type) {
    Scanner* s = new Scanner();
    s->f = f;
    s->preview = preview;
    s->tid = tid;
    s->end1 = end1;
    s->min_mapq = min_mapq;
    s->max_num_cigar = max_num_cigar;
    s->max_read_span = max_read_span;
    s->min_bundle_gap = min_bundle_gap;
    s->use_second = use_second;
    s->uniq_only = uniq_only;
    s->library_type = library_type;
    return s;
}

// ALETSCH_REF_QUIRKS: apply the mate-span filter to ANY read with 0x8
// unset (generator.cc:95), reproducing the reference's silent drop of
// single-end/long reads past max_read_span for byte-parity runs
void abam_scan_set_quirks(Scanner* s, int32_t q) { s->span_quirk = q; }

void abam_scan_free(Scanner* s) { delete s; }

// enable the piggybacked region-boundary tracker (call right after
// abam_scan_open, before the first abam_scan_next)
void abam_scan_enable_boundaries(Scanner* s, int64_t region_len) {
    s->brl = region_len;
    size_t nt = s->f->targets.size();
    s->bs1.resize(nt); s->bs2.resize(nt);
    s->boff.resize(nt); s->be1.resize(nt);
    for (size_t i = 0; i < nt; i++) {
        size_t n = (size_t)(s->f->targets[i].len / region_len + 1);
        s->bs1[i].assign(n, 0);
        s->bs2[i].assign(n, 0);
        s->boff[i].assign(n, 0);
        s->be1[i].assign(n, 0);
    }
}

// after the preview consumer stops collecting (insert-size cap), decode
// the rest of the file updating ONLY the boundary tracker -- no bundle
// routing or marshalling.  Returns 0 at EOF.
int abam_scan_drain_boundaries(Scanner* s) {
    static const int CONSUME_REF =
        (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8);
    BamFile* f = s->f;
    while (!s->done) {
        uint64_t bvoff = abam_tell(f);
        uint8_t b4[4];
        if (bread(f, b4, 4) < 4) { s->done = true; break; }
        int32_t block_size = rd32(b4);
        if (block_size <= 0) { s->done = true; break; }
        s->rec.resize(block_size);
        if ((int)bread(f, s->rec.data(), block_size) < block_size) {
            s->done = true;
            break;
        }
        const uint8_t* p = s->rec.data();
        int32_t refID = rd32(p + 0);
        int32_t pos = rd32(p + 4);
        uint8_t l_read_name = p[8];
        uint16_t n_cigar = p[12] | (p[13] << 8);
        uint16_t flag = p[14] | (p[15] << 8);
        if (flag & 0x4) continue;
        const uint8_t* cp = p + 32 + l_read_name;
        int32_t ref_len = 0;
        for (int k = 0; k < n_cigar; k++) {
            uint32_t c;
            memcpy(&c, cp + 4ull * k, 4);
            if ((CONSUME_REF >> (c & 0xF)) & 1) ref_len += (int32_t)(c >> 4);
        }
        boundary_update(s, refID, pos, pos + ref_len, bvoff);
    }
    return 0;
}

// close the final region and export one target's boundary rows; n is the
// row count for that target (target_len / region_len + 1)
void abam_scan_boundary_fill(Scanner* s, int32_t tid, int64_t* start1,
                             int64_t* start2, uint64_t* start_off,
                             int64_t* end1) {
    if (s->btid >= 0) {             // close once; idempotent via btid reset
        s->be1[s->btid][s->brid] = s->brpos;
        s->btid = -1;
    }
    const auto& v1 = s->bs1[tid];
    size_t n = v1.size();
    memcpy(start1, v1.data(), n * sizeof(int64_t));
    memcpy(start2, s->bs2[tid].data(), n * sizeof(int64_t));
    memcpy(start_off, s->boff[tid].data(), n * sizeof(uint64_t));
    memcpy(end1, s->be1[tid].data(), n * sizeof(int64_t));
}

void abam_scan_drop(Scanner* s) { s->out.clear(); }

int abam_scan_nbundles(Scanner* s) { return (int)s->out.size(); }

// Chunk-pooled marshalling: one sizes + one fill call for every flushed
// bundle of the chunk.  meta is 14 int64 per bundle:
// (strand, tid, lpos, rpos, rows, qname bytes, coord len, mev len,
//  iev len, epoch, frg len, splice len, XS '+' count, XS '-' count).
void abam_scan_chunk_sizes(Scanner* s, int64_t* out7) {
    int64_t rows = 0, qn = 0, co = 0, me = 0, ie = 0, fr = 0, sp = 0;
    for (const FlushedBundle& fb : s->out) {
        rows += (int64_t)fb.fixed.size() / 25;
        qn += (int64_t)fb.qnames.size();
        co += (int64_t)fb.coords.size();
        me += (int64_t)fb.mev.size();
        ie += (int64_t)fb.iev.size();
        fr += (int64_t)fb.frgs.size();
        sp += (int64_t)fb.splices.size();
    }
    out7[0] = rows; out7[1] = qn; out7[2] = co;
    out7[3] = me; out7[4] = ie; out7[5] = fr; out7[6] = sp;
}

void abam_scan_chunk_fill(Scanner* s, int64_t* meta, int32_t* fixed,
                          char* qnames, int32_t* coords, int32_t* mev,
                          int32_t* iev, int32_t* frgs, int32_t* splices) {
    for (size_t b = 0; b < s->out.size(); b++) {
        const FlushedBundle& fb = s->out[b];
        int64_t* m = meta + 14 * b;
        m[0] = fb.strand;
        m[1] = fb.tid;
        m[2] = fb.lpos;
        m[3] = fb.rpos;
        m[4] = (int64_t)fb.fixed.size() / 25;
        m[5] = (int64_t)fb.qnames.size();
        m[6] = (int64_t)fb.coords.size();
        m[7] = (int64_t)fb.mev.size();
        m[8] = (int64_t)fb.iev.size();
        m[9] = fb.epoch;
        m[10] = (int64_t)fb.frgs.size();
        m[11] = (int64_t)fb.splices.size();
        m[12] = fb.xsp;
        m[13] = fb.xsm;
        memcpy(fixed, fb.fixed.data(), fb.fixed.size() * sizeof(int32_t));
        fixed += fb.fixed.size();
        if (qnames) {
            memcpy(qnames, fb.qnames.data(), fb.qnames.size());
            qnames += fb.qnames.size();
        }
        memcpy(coords, fb.coords.data(), fb.coords.size() * sizeof(int32_t));
        coords += fb.coords.size();
        memcpy(mev, fb.mev.data(), fb.mev.size() * sizeof(int32_t));
        mev += fb.mev.size();
        memcpy(iev, fb.iev.data(), fb.iev.size() * sizeof(int32_t));
        iev += fb.iev.size();
        memcpy(frgs, fb.frgs.data(), fb.frgs.size() * sizeof(int32_t));
        frgs += fb.frgs.size();
        memcpy(splices, fb.splices.data(),
               fb.splices.size() * sizeof(int32_t));
        splices += fb.splices.size();
    }
}

// Process up to max_records records.  Returns 1 while more input remains,
// 0 once the region/file is exhausted (open bundles are flushed in region
// mode; preview mode leaves trailing bundles unprocessed, matching
// previewer.cc which stops collecting at EOF).
int abam_scan_next(Scanner* s, int64_t max_records) {
    static const int CONSUME_REF =
        (1 << 0) | (1 << 2) | (1 << 3) | (1 << 7) | (1 << 8);
    BamFile* f = s->f;
    std::vector<int32_t> coords;
    coords.reserve(64);
    for (int64_t processed = 0; processed < max_records; processed++) {
        if (s->done) break;
        uint64_t bvoff = s->brl ? abam_tell(f) : 0;
        uint8_t b4[4];
        if (bread(f, b4, 4) < 4) {
            s->done = true;
            if (!s->preview) { flush_bundle(s, 0); flush_bundle(s, 1); }
            break;
        }
        int32_t block_size = rd32(b4);
        if (block_size <= 0) {
            s->done = true;
            if (!s->preview) { flush_bundle(s, 0); flush_bundle(s, 1); }
            break;
        }
        s->rec.resize(block_size);
        if ((int)bread(f, s->rec.data(), block_size) < block_size) {
            s->done = true;
            if (!s->preview) { flush_bundle(s, 0); flush_bundle(s, 1); }
            break;
        }
        const uint8_t* p = s->rec.data();
        int32_t refID = rd32(p + 0);
        int32_t pos = rd32(p + 4);
        uint8_t l_read_name = p[8];
        uint8_t mapq = p[9];
        uint16_t n_cigar = p[12] | (p[13] << 8);
        uint16_t flag = p[14] | (p[15] << 8);
        int32_t l_seq = rd32(p + 16);
        int32_t next_pos = rd32(p + 24);
        if (!s->preview && (pos >= s->end1 || refID != s->tid)) {
            s->done = true;
            flush_bundle(s, 0);
            flush_bundle(s, 1);
            break;
        }
        // filters (generator.py keep mask / previewer.py keep mask); the
        // boundary tracker (brl != 0) taps the raw mapped stream BEFORE
        // the preview filters, so it still needs ref_len for records the
        // preview drops
        if (flag & 0x4) continue;
        bool keep = !((flag & 0x100) && (s->preview || !s->use_second))
                    && n_cigar <= s->max_num_cigar && n_cigar >= 1
                    && mapq >= s->min_mapq;
        if (!keep && s->brl == 0) continue;
        size_t off = 32 + l_read_name;
        s->cig.resize(n_cigar);
        memcpy(s->cig.data(), p + off, 4ull * n_cigar);
        int32_t ref_len = 0, total_n_ops = 0;
        for (int k = 0; k < n_cigar; k++) {
            uint32_t c = s->cig[k];
            int op = c & 0xF;
            if (op == 3) total_n_ops++;
            if ((CONSUME_REF >> op) & 1) ref_len += (int32_t)(c >> 4);
        }
        int32_t rpos = pos + ref_len;
        if (s->brl) {
            boundary_update(s, refID, pos, rpos, bvoff);
            if (!keep) continue;
        }
        if (!s->preview) {
            if (llabs((int64_t)pos - rpos) >= s->max_read_span) continue;
            // mate-span filter only for paired reads with a mapped mate:
            // the reference applies it whenever 0x8 is unset
            // (generator.cc:95), which on single-end/long-read BAMs
            // (mpos = -1, 0x8 meaningless without 0x1) drops every read
            // past coordinate max_read_span — documented divergence
            // quirks mode (ALETSCH_REF_QUIRKS) replicates the reference
            // exactly — any read with 0x8 unset — for byte-parity runs
            if ((s->span_quirk || (flag & 0x1)) && !(flag & 0x8) &&
                llabs((int64_t)pos - next_pos) >= s->max_read_span) continue;
            bool dup = (pos == s->pre_lpos && rpos == s->pre_rpos);
            s->pre_lpos = pos;
            s->pre_rpos = rpos;
            if (dup) continue;
        }
        int32_t my_hid = s->hid++;
        // bundle flushes before routing (order: '+', then '-')
        for (int k = 0; k < 2; k++) {
            if (s->bb[k].n > 0 &&
                (refID != s->bb[k].tid ||
                 (int64_t)pos > s->bb[k].rpos + s->min_bundle_gap))
                flush_bundle(s, k);
        }
        // aux tags
        int32_t xs = '.', ts = '.', hi = -1, nh = -1, nm = 0;
        {
            size_t aoff = off + 4ull * n_cigar + (l_seq + 1) / 2 + l_seq;
            while (aoff + 3 <= (size_t)block_size) {
                char t0 = (char)p[aoff], t1 = (char)p[aoff + 1];
                char typ = (char)p[aoff + 2];
                aoff += 3;
                int64_t val = 0;
                bool have = false;
                switch (typ) {
                    case 'A': val = p[aoff]; aoff += 1; have = true; break;
                    case 'c': val = (int8_t)p[aoff]; aoff += 1; have = true; break;
                    case 'C': val = p[aoff]; aoff += 1; have = true; break;
                    case 's': { int16_t v; memcpy(&v, p + aoff, 2); val = v; aoff += 2; have = true; break; }
                    case 'S': { uint16_t v; memcpy(&v, p + aoff, 2); val = v; aoff += 2; have = true; break; }
                    case 'i': { int32_t v; memcpy(&v, p + aoff, 4); val = v; aoff += 4; have = true; break; }
                    case 'I': { uint32_t v; memcpy(&v, p + aoff, 4); val = v; aoff += 4; have = true; break; }
                    case 'f': aoff += 4; break;
                    case 'Z': case 'H': {
                        while (aoff < (size_t)block_size && p[aoff] != 0) aoff++;
                        aoff++;
                        break;
                    }
                    case 'B': {
                        char sub = (char)p[aoff];
                        int32_t cnt; memcpy(&cnt, p + aoff + 1, 4);
                        int sz = (sub == 'c' || sub == 'C') ? 1 :
                                 (sub == 's' || sub == 'S') ? 2 : 4;
                        aoff += 5 + (int64_t)cnt * sz;
                        break;
                    }
                    default: aoff = block_size; break;
                }
                if (!have) continue;
                if (t0 == 'X' && t1 == 'S' && typ == 'A') xs = (int32_t)val;
                else if (t0 == 't' && t1 == 's' && typ == 'A') ts = (int32_t)val;
                else if (t0 == 'H' && t1 == 'I') hi = (int32_t)val;
                else if (t0 == 'N' && t1 == 'H') nh = (int32_t)val;
                else if ((t0 == 'N' || t0 == 'n') && (t1 == 'M' || t1 == 'm')) nm = (int32_t)val;
            }
            if (xs == '.' && ts != '.') {
                bool rev = (flag & 0x10) != 0;
                if (ts == '+') xs = rev ? '-' : '+';
                else if (ts == '-') xs = rev ? '+' : '-';
            }
        }
        if (s->uniq_only && nh != 1) continue;
        int32_t strand = strand_of(flag, s->library_type);
        bool unstranded = (s->library_type == 0);
        if (!unstranded) {
            if (strand == '+' && xs == '-') continue;
            if (strand == '-' && xs == '+') continue;
            if (strand == '.' && xs != '.') strand = xs;
        } else if (!s->preview && xs == '.' && total_n_ops != 0) {
            continue;              // spliced without XS: dropped (generator)
        }
        // coordinate layout: match pairs | interior splices | indel pairs
        coords.clear();
        int32_t m_cnt = 0, s_cnt = 0, i_cnt = 0;
        {
            int32_t gp = pos;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = s->cig[k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (op == 0) {
                    coords.push_back(gp - ln);
                    coords.push_back(gp);
                    m_cnt++;
                }
            }
            gp = pos;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = s->cig[k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (k == 0 || k == n_cigar - 1) continue;
                if (op != 3) continue;
                coords.push_back(gp - ln);
                coords.push_back(gp);
                s_cnt += 2;
            }
            gp = pos;
            for (int k = 0; k < n_cigar; k++) {
                uint32_t c = s->cig[k];
                int op = c & 0xF;
                int32_t ln = (int32_t)(c >> 4);
                if ((CONSUME_REF >> op) & 1) gp += ln;
                if (op == 1) {
                    coords.push_back(gp - 1);
                    coords.push_back(gp + 1);
                    i_cnt++;
                } else if (op == 2) {
                    coords.push_back(gp - ln);
                    coords.push_back(gp);
                    i_cnt++;
                }
            }
        }
        int32_t fx[24];
        fx[0] = refID; fx[1] = pos; fx[2] = rpos; fx[3] = mapq;
        fx[4] = flag; fx[5] = rd32(p + 20); fx[6] = next_pos;
        fx[7] = rd32(p + 28); fx[8] = n_cigar; fx[9] = 0;
        fx[10] = 0; fx[11] = l_read_name - 1; fx[12] = xs; fx[13] = hi;
        fx[14] = nh; fx[15] = nm; fx[16] = s_cnt / 2; fx[17] = 0;
        fx[18] = m_cnt; fx[19] = s_cnt; fx[20] = i_cnt; fx[21] = total_n_ops;
        const char* qn = (const char*)(p + 32);
        int32_t qlen = l_read_name - 1;
        fx[22] = '.';
        // qname hash for mate-pair bucketing, identical to Python
        // zlib.crc32 (core/hits.py get_qhash)
        fx[23] = (int32_t)crc32(0L, (const Bytef*)qn, (uInt)qlen);
        int32_t clen = (int32_t)coords.size();
        if (!unstranded) {
            if (strand == '+')
                add_to(s, 0, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
            if (strand == '-')
                add_to(s, 1, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
        } else {
            if (xs == '+')
                add_to(s, 0, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
            else if (xs == '-')
                add_to(s, 1, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
            else {
                add_to(s, 0, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
                add_to(s, 1, fx, strand, my_hid, qn, qlen, coords.data(),
                       clen, m_cnt, s_cnt, i_cnt);
            }
        }
    }
    return s->done ? 0 : 1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Pereads clustering: build_pereads_clusters (rnacore/graph_cluster.cc:13-203)
// natively.  The caller exports the positional splice graph as flat arrays
// (interior vertex intervals, next-vertex adjacency, lpos/rpos boundary maps)
// plus hit coordinates, per-hit intron chains and candidate fragments; the
// engine aligns both mates to vertex paths, groups identical path pairs,
// recursively partitions each group on the four mate coordinates, and
// returns clusters (representative fragment, count, averaged bounds, extend,
// member list) plus which fragments became bridgeable.  Semantics mirror
// aletsch_tpu/core/graph_cluster.py exactly (fuzz-tested differentially).

#include <algorithm>
#include <array>
#include <map>
#include <unordered_map>

namespace {

struct ClusterOut {
    std::vector<int32_t> meta;     // per cluster: rep_frag, count, bounds[4], extend[4]
    std::vector<int32_t> members;  // frlist pool
    std::vector<int32_t> moff;     // per cluster offset into members
    std::vector<uint8_t> aligned;  // per input fragment: 1 if both mates aligned
};

struct CGraph {
    int32_t n_interior;
    const int32_t* vstarts;        // lpos of vertex i+1
    const int32_t* vends;          // rpos of vertex i+1
    const uint8_t* adj_next;       // edge (i+1)->(i+2) exists, len n_interior-1
    int32_t n_r;
    const int32_t* rkeys;          // sorted rpos keys
    const int32_t* rvals;          // vertex for each key
    int32_t n_l;
    const int32_t* lkeys;
    const int32_t* lvals;
};

int32_t bfind(const int32_t* keys, const int32_t* vals, int32_t n, int32_t p) {
    const int32_t* it = std::lower_bound(keys, keys + n, p);
    if (it == keys + n || *it != p) return -1;
    return vals[it - keys];
}

// locate_vertex (splice_graph.cc:1166): interior vertex covering p, or -1
int32_t locate(const CGraph& g, int32_t p) {
    // index of first start > p
    const int32_t* it = std::upper_bound(g.vstarts, g.vstarts + g.n_interior, p);
    int64_t i = it - g.vstarts;        // == bisect_right
    if (i == 0) return -1;
    if (g.vstarts[i - 1] <= p && p < g.vends[i - 1]) return (int32_t)i;
    return -1;
}

bool continuous(const CGraph& g, int32_t x, int32_t y) {
    // essential.cc:436-446 over interior vertices (x, y are vertex ids)
    if (x >= y) return true;
    for (int32_t v = x; v < y; v++) {
        if (!g.adj_next[v - 1]) return false;
        if (g.vends[v - 1] != g.vstarts[v]) return false;
    }
    return true;
}

// align one mate; returns false on failure; on success fills first/last and
// the grouping key ({-1, a, b} for contiguous vertex ranges)
// reusable scratch for align_mate: the per-call vector allocations were a
// measurable slice of the bridge phase (build_pereads_clusters is the
// hottest native function on the production soak)
struct MateScratch {
    std::vector<int32_t> pa, pb, uu, vv;
};

bool align_mate(const CGraph& g, int32_t pos, int32_t rpos,
                const int32_t* chain, int32_t clen,
                int32_t u1, int32_t u2,
                int32_t& first, int32_t& last, std::vector<int32_t>& key,
                MateScratch& ms) {
    if (u1 < 0 || u2 < 0 || u1 > u2) return false;
    key.clear();
    if (clen == 0) {
        if (pos > rpos) return false;
        first = u1; last = u2;
        key.push_back(-1); key.push_back(u1); key.push_back(u2);
        return true;
    }
    // check_increasing over [pos, chain..., rpos] (non-strict)
    int32_t prev = pos;
    for (int32_t k = 0; k < clen; k++) {
        if (chain[k] < prev) return false;
        prev = chain[k];
    }
    if (rpos < prev) return false;
    // build_path_from_intron_coordinates (essential.cc:368-403)
    std::vector<int32_t>& pa = ms.pa;
    std::vector<int32_t>& pb = ms.pb;
    pa.clear();
    pb.clear();
    int32_t n = clen / 2;
    for (int32_t k = 0; k < n; k++) {
        int32_t p = chain[2 * k], q = chain[2 * k + 1];
        if (p >= q) return false;
        int32_t a = bfind(g.rkeys, g.rvals, g.n_r, p);
        int32_t b = bfind(g.lkeys, g.lvals, g.n_l, q);
        if (a < 0 || b < 0) return false;
        pa.push_back(a); pb.push_back(b);
    }
    std::vector<int32_t>& uu = ms.uu;
    uu.clear();
    uu.push_back(pa[0]);
    for (int32_t k = 0; k + 1 < n; k++) {
        int32_t a = pb[k], b = pa[k + 1];
        if (a > b) return false;
        if (!continuous(g, a, b)) return false;
        for (int32_t v = a; v <= b; v++) uu.push_back(v);
    }
    uu.push_back(pb[n - 1]);
    // vv = range(u1, uu[0]) + uu + range(uu[-1]+1, u2+1)
    std::vector<int32_t>& vv = ms.vv;
    vv.clear();
    for (int32_t v = u1; v < uu.front(); v++) vv.push_back(v);
    vv.insert(vv.end(), uu.begin(), uu.end());
    for (int32_t v = uu.back() + 1; v <= u2; v++) vv.push_back(v);
    first = vv.front(); last = vv.back();
    bool contig = ((int64_t)vv.size() == (int64_t)last - first + 1);
    if (contig) {
        for (size_t k = 0; k < vv.size(); k++)
            if (vv[k] != first + (int32_t)k) { contig = false; break; }
    }
    if (contig) {
        key.push_back(-1); key.push_back(first); key.push_back(last);
    } else {
        key = vv;
    }
    return true;
}

// recursive four-coordinate partition (graph_cluster.cc:170-203):
// rows of (c0..c3, original index), stable-sorted per level, split at gaps
void partition_rec(std::vector<std::array<int32_t, 5>>& rows,
                   size_t lo, size_t hi, int r, int32_t max_gap,
                   std::vector<std::vector<int32_t>>& out) {
    if (lo >= hi) return;
    if (r >= 4) {
        std::vector<int32_t> z;
        for (size_t k = lo; k < hi; k++) z.push_back(rows[k][4]);
        out.push_back(std::move(z));
        return;
    }
    std::stable_sort(rows.begin() + lo, rows.begin() + hi,
                     [r](const std::array<int32_t, 5>& a,
                         const std::array<int32_t, 5>& b) {
                         return a[r] < b[r];
                     });
    size_t pre = lo;
    for (size_t k = lo + 1; k <= hi; k++) {
        if (k < hi && rows[k][r] - rows[k - 1][r] <= max_gap) continue;
        partition_rec(rows, pre, k, r + 1, max_gap, out);
        pre = k;
    }
}

}  // namespace

extern "C" {

ClusterOut* abam_cluster_pereads(
    int32_t n_interior, const int32_t* vstarts, const int32_t* vends,
    const uint8_t* adj_next,
    int32_t n_r, const int32_t* rkeys, const int32_t* rvals,
    int32_t n_l, const int32_t* lkeys, const int32_t* lvals,
    const int32_t* hpos, const int32_t* hrpos,
    const int32_t* chain_off, const int32_t* chain_len,
    const int32_t* chain_pool,
    int32_t n_cand, const int32_t* cand_frag, const int32_t* cand_h1,
    const int32_t* cand_h2,
    int32_t max_gap) {
    CGraph g{n_interior, vstarts, vends, adj_next,
             n_r, rkeys, rvals, n_l, lkeys, lvals};
    ClusterOut* out = new ClusterOut();
    out->aligned.assign(n_cand, 0);
    // grouping: key pair -> group id.  Group ids are assigned first-seen
    // (gi = groups.size() on first encounter) and all output iteration is
    // over `groups`, so the index container's ordering is irrelevant — a
    // hash map replaces the former std::map (vector-pair tree compares
    // were hot on the production soak) with identical output.
    struct KeyHash {
        size_t operator()(const std::pair<std::vector<int32_t>,
                                          std::vector<int32_t>>& kk) const {
            uint64_t x = 0xcbf29ce484222325ULL;
            for (int32_t v : kk.first) {
                x ^= (uint32_t)v; x *= 0x100000001b3ULL;
            }
            x ^= 0x9e3779b97f4a7c15ULL;
            for (int32_t v : kk.second) {
                x ^= (uint32_t)v; x *= 0x100000001b3ULL;
            }
            return (size_t)x;
        }
    };
    std::unordered_map<std::pair<std::vector<int32_t>, std::vector<int32_t>>,
                       int32_t, KeyHash> findex;
    struct Group {
        std::array<int32_t, 4> extend;
        // member entries: frag index + the four mate coordinates
        std::vector<std::array<int32_t, 5>> rows;
        std::vector<int32_t> frags;
    };
    std::vector<Group> groups;
    std::vector<int32_t> k1(2), k2v(2);
    MateScratch ms;
    std::vector<int32_t> key1, key2;
    std::pair<std::vector<int32_t>, std::vector<int32_t>> kk;
    for (int32_t c = 0; c < n_cand; c++) {
        int32_t h1 = cand_h1[c], h2 = cand_h2[c];
        int32_t p1 = hpos[h1], r1p = hrpos[h1];
        int32_t p2 = hpos[h2], r2p = hrpos[h2];
        int32_t u1a = locate(g, p1), u2a = locate(g, r1p - 1);
        int32_t u1b = locate(g, p2), u2b = locate(g, r2p - 1);
        int32_t f1, l1, f2, l2;
        if (!align_mate(g, p1, r1p, chain_pool + chain_off[h1],
                        chain_len[h1], u1a, u2a, f1, l1, key1, ms))
            continue;
        if (!align_mate(g, p2, r2p, chain_pool + chain_off[h2],
                        chain_len[h2], u1b, u2b, f2, l2, key2, ms))
            continue;
        out->aligned[c] = 1;
        kk.first.swap(key1);
        kk.second.swap(key2);
        auto it = findex.find(kk);
        int32_t gi;
        if (it == findex.end()) {
            gi = (int32_t)groups.size();
            findex.emplace(std::move(kk), gi);
            groups.push_back(Group());
            groups[gi].extend = {g.vstarts[f1 - 1], g.vends[l1 - 1],
                                 g.vstarts[f2 - 1], g.vends[l2 - 1]};
        } else {
            gi = it->second;
        }
        Group& G = groups[gi];
        int32_t idx = (int32_t)G.rows.size();
        G.rows.push_back({p1, r1p, p2, r2p, idx});
        G.frags.push_back(cand_frag[c]);
    }
    // per group: recursive partition, then cluster stats
    for (auto& G : groups) {
        std::vector<std::vector<int32_t>> zz;
        partition_rec(G.rows, 0, G.rows.size(), 0, max_gap, zz);
        // rows were re-sorted; rebuild coordinate lookup by original idx
        std::vector<std::array<int32_t, 4>> coords(G.rows.size());
        for (auto& row : G.rows)
            coords[row[4]] = {row[0], row[1], row[2], row[3]};
        for (auto& z : zz) {
            if (z.empty()) continue;
            const auto& base = coords[z[0]];
            int64_t acc[4] = {0, 0, 0, 0};
            for (int32_t k : z)
                for (int d = 0; d < 4; d++)
                    acc[d] += coords[k][d] - base[d];
            int32_t cnt = (int32_t)z.size();
            out->meta.push_back(G.frags[z[0]]);
            out->meta.push_back(cnt);
            for (int d = 0; d < 4; d++)
                out->meta.push_back((int32_t)(acc[d] / cnt) + base[d]);
            for (int d = 0; d < 4; d++)
                out->meta.push_back(G.extend[d]);
            out->moff.push_back((int32_t)out->members.size());
            for (int32_t k : z)
                out->members.push_back(G.frags[k]);
        }
    }
    return out;
}

void abam_cluster_sizes(ClusterOut* o, int64_t* out3) {
    out3[0] = (int64_t)o->moff.size();       // clusters
    out3[1] = (int64_t)o->members.size();
    out3[2] = (int64_t)o->aligned.size();
}

void abam_cluster_fill(ClusterOut* o, int32_t* meta, int32_t* moff,
                       int32_t* members, uint8_t* aligned) {
    memcpy(meta, o->meta.data(), o->meta.size() * sizeof(int32_t));
    memcpy(moff, o->moff.data(), o->moff.size() * sizeof(int32_t));
    memcpy(members, o->members.data(), o->members.size() * sizeof(int32_t));
    memcpy(aligned, o->aligned.data(), o->aligned.size());
}

void abam_cluster_free(ClusterOut* o) { delete o; }

}  // extern "C"
