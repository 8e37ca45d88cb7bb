// core_tset.h — native transcript-set merge + GTF/CSV writers.
//
// Re-implements aletsch_tpu/core/transcript_set.py (rnacore/
// transcript_set.{h,cc}) and the output writers (io/gtf.py Transcript.write
// / write_features, gtf/transcript.cc:318-428) so the per-wave replay, the
// global per-(chrm,strand) fold and the output phase run without the GIL.
// The Python TranscriptSet remains the byte-exact oracle: the incubator
// keeps both paths and the differential tests compare final output bytes.
//
// Semantics mirrored exactly:
//  - bucket key = intron-chain hash (transcript.cc:183-201; the Python side
//    keys by hash+1 in unbounded arithmetic — sorting by the raw uint64 is
//    the same order because +1 never wraps in Python)
//  - within a bucket: sorted merge-join via compare1 (transcript.cc:269-300)
//  - merge mode TRANSCRIPT_COUNT_ADD_COVERAGE_ADD (transcript_set.cc:38-81)
//    with the deferred per-sample-copy propagation of
//    core/transcript_set.py::sync_samples
//  - sample copies are insertion-ordered (Python dict semantics)
//  - writers: 4-decimal GTF attributes, %.6g feature columns with the
//    FEATURE_INT_COLUMNS truncation mask (io/gtf.py)

#ifndef ALETSCH_CORE_TSET_H
#define ALETSCH_CORE_TSET_H

#include <algorithm>
#include <atomic>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace core_tset {

typedef int32_t i32;
typedef int64_t i64;

struct NTrans {
    std::string gene_id, tid, meta_tid;
    char strand = '.';
    double coverage = 0, cov2 = 0, conf = 0, abd = 0;
    i64 count1 = 0;
    i32 count2 = 0;
    std::vector<i64> exons;       // flat (start, end) pairs
    std::vector<double> feat;     // N_FEATURES columns (empty ok)

    size_t nex() const { return exons.size() / 2; }
    i64 e(size_t i, int j) const { return exons[2 * i + j]; }
    i64 length() const {
        i64 s = 0;
        for (size_t i = 0; i < nex(); i++) s += e(i, 1) - e(i, 0);
        return s;
    }
    // transcript.cc:214-220 / io/gtf.py extend_bounds
    void extend_bounds(const NTrans& t) {
        if (exons.empty() || t.exons.empty()) return;
        if (t.exons.front() < exons.front()) exons.front() = t.exons.front();
        if (t.exons.back() > exons.back()) exons.back() = t.exons.back();
    }
};

struct NItem {
    NTrans trst;
    i64 count = 0;
    std::vector<std::pair<i32, NTrans>> samples;   // insertion-ordered
};

struct NTSet {
    double seo = 0;     // min_single_exon_clustering_overlap
    std::unordered_map<uint64_t, std::vector<NItem>> mt;
};

// intron-chain bucket hash (transcript.cc:183-201, matches
// core_batch_hashes in core.cpp WITHOUT the trailing +1)
static inline uint64_t chain_hash(const std::vector<i64>& ex) {
    size_t ne = ex.size() / 2;
    if (ne == 0) return 0;
    if (ne == 1) return (uint64_t)((ex[0] + ex[1]) / 10000);
    uint64_t x = 0xcbf29ce484222325ULL;            // FNV-1a (utils/seqs.py)
    for (size_t j = 1; j < ne; j++) {
        x ^= (uint64_t)ex[2 * (j - 1) + 1];
        x *= 0x100000001b3ULL;
        x ^= (uint64_t)ex[2 * j];
        x *= 0x100000001b3ULL;
    }
    return x;
}

// transcript.cc:218-237 (io/gtf.py intron_chain_compare, incl. the
// reference's k in [1, n-1) internal-exon loop bounds)
static inline int chain_cmp(const NTrans& a, const NTrans& b) {
    size_t na = a.nex(), nb = b.nex();
    if (na < nb) return +1;
    if (na > nb) return -1;
    if (na <= 1) return 0;
    size_t n = na - 1;
    if (a.e(0, 1) < b.e(0, 1)) return +1;
    if (a.e(0, 1) > b.e(0, 1)) return -1;
    for (size_t k = 1; k + 1 < n; k++) {
        if (a.e(k, 0) < b.e(k, 0)) return +1;
        if (a.e(k, 0) > b.e(k, 0)) return -1;
        if (a.e(k, 1) < b.e(k, 1)) return +1;
        if (a.e(k, 1) > b.e(k, 1)) return -1;
    }
    if (a.e(n, 0) < b.e(n, 0)) return +1;
    if (a.e(n, 0) > b.e(n, 0)) return -1;
    return 0;
}

// transcript.cc:269-300 (seqname compare elided: a set holds one chrm)
static inline int compare1(const NTrans& a, const NTrans& b, double seo) {
    if (a.nex() < b.nex()) return +1;
    if (a.nex() > b.nex()) return -1;
    if (a.strand < b.strand) return +1;
    if (a.strand > b.strand) return -1;
    if (a.nex() == 1) {
        i64 p2 = a.e(0, 0) > b.e(0, 0) ? a.e(0, 0) : b.e(0, 0);
        i64 q2 = a.e(0, 1) < b.e(0, 1) ? a.e(0, 1) : b.e(0, 1);
        double overlap = (double)(q2 - p2);
        if (overlap >= seo * (double)a.length()) return 0;
        if (overlap >= seo * (double)b.length()) return 0;
        if (a.e(0, 0) < b.e(0, 0)) return +1;
        if (a.e(0, 0) > b.e(0, 0)) return -1;
        if (a.e(0, 1) < b.e(0, 1)) return +1;
        if (a.e(0, 1) > b.e(0, 1)) return -1;
    }
    return chain_cmp(a, b);
}

// trans_item::merge, TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
// (transcript_set.cc:38-81); per-sample-copy propagation deferred to
// nts_sync like core/transcript_set.py
static inline void item_merge(NItem& x, NItem& y) {
    NTrans& t = x.trst;
    NTrans& s = y.trst;
    if (t.nex() >= 2) t.coverage += s.coverage;
    else if (t.coverage < s.coverage) t.coverage = s.coverage;
    t.extend_bounds(s);
    x.count += y.count;
    if (s.cov2 > t.cov2) t.cov2 = s.cov2;
    if (s.conf > t.conf) t.conf = s.conf;
    if (s.abd > t.abd) t.abd = s.abd;
    if (s.count1 > t.count1) t.count1 = s.count1;
    for (auto& sc : y.samples) {
        NTrans* mine = nullptr;
        for (auto& p : x.samples)
            if (p.first == sc.first) { mine = &p.second; break; }
        if (mine == nullptr) {
            x.samples.push_back(std::move(sc));
        } else {
            NTrans& c = sc.second;
            if (c.cov2 > mine->cov2) mine->cov2 = c.cov2;
            if (c.conf > mine->conf) mine->conf = c.conf;
            if (c.abd > mine->abd) mine->abd = c.abd;
            if (c.count1 > mine->count1) mine->count1 = c.count1;
        }
    }
    t.count2 = (i32)x.samples.size();
}

// transcript_set.cc:83-120 (consumes both inputs)
static inline std::vector<NItem> merge_sorted(std::vector<NItem>& vx,
                                              std::vector<NItem>& vy,
                                              double seo) {
    std::vector<NItem> vz;
    vz.reserve(vx.size() + vy.size());
    size_t kx = 0, ky = 0;
    while (kx < vx.size() && ky < vy.size()) {
        int b = compare1(vx[kx].trst, vy[ky].trst, seo);
        if (b == 0) {
            item_merge(vx[kx], vy[ky]);
            vz.push_back(std::move(vx[kx]));
            kx++;
            ky++;
        } else if (b == 1) {
            vz.push_back(std::move(vx[kx]));
            kx++;
        } else {
            vz.push_back(std::move(vy[ky]));
            ky++;
        }
    }
    for (; kx < vx.size(); kx++) vz.push_back(std::move(vx[kx]));
    for (; ky < vy.size(); ky++) vz.push_back(std::move(vy[ky]));
    return vz;
}

// transcript_set.cc:156-175 add(): bucket-level union; whole-bucket moves
// mirror the Python aliasing (mt[h] = items) since src is discarded
static inline void set_add(NTSet* dst, NTSet* src) {
    for (auto& kv : src->mt) {
        auto it = dst->mt.find(kv.first);
        if (it == dst->mt.end())
            dst->mt.emplace(kv.first, std::move(kv.second));
        else
            it->second = merge_sorted(it->second, kv.second, dst->seo);
    }
    src->mt.clear();
}

static inline void set_insert_item(NTSet* ts, uint64_t key, NItem&& it) {
    auto f = ts->mt.find(key);
    if (f == ts->mt.end()) {
        std::vector<NItem> v;
        v.push_back(std::move(it));
        ts->mt.emplace(key, std::move(v));
    } else {
        std::vector<NItem> v;
        v.push_back(std::move(it));
        f->second = merge_sorted(f->second, v, ts->seo);
    }
}

// deferred propagation (core/transcript_set.py sync_samples;
// transcript_set.cc:68-76 applied once)
static inline void set_sync(NTSet* s) {
    for (auto& kv : s->mt)
        for (NItem& z : kv.second) {
            NTrans& t = z.trst;
            i32 n = (i32)z.samples.size();
            t.count2 = n;
            for (auto& p : z.samples) {
                p.second.coverage = t.coverage;
                p.second.count2 = n;
                p.second.meta_tid = t.tid;
            }
        }
}

static inline std::vector<uint64_t> sorted_keys(const NTSet* s) {
    std::vector<uint64_t> ks;
    ks.reserve(s->mt.size());
    for (auto& kv : s->mt) ks.push_back(kv.first);
    std::sort(ks.begin(), ks.end());
    return ks;
}

// ------------------------------------------------------------------ writers

// io/gtf.py Transcript.write (transcript.cc:318-360); cov2 < -0.5 /
// count < 0 omit the attribute like the Python defaults
static inline void write_gtf_rec(FILE* f, const NTrans& t,
                                 const char* seqname, const char* source,
                                 double cov2, i64 count) {
    if (t.exons.empty()) return;
    i64 p1 = t.exons.front(), p2 = t.exons.back();
    char attrs[1024];
    int m = snprintf(attrs, sizeof(attrs),
                     "gene_id \"%s\"; transcript_id \"%s\"; cov \"%.4f\"; ",
                     t.gene_id.c_str(), t.tid.c_str(), t.coverage);
    if (cov2 >= -0.5 && m > 0 && m < (int)sizeof(attrs))
        m += snprintf(attrs + m, sizeof(attrs) - m, "cov2 \"%.4f\"; ", cov2);
    if (count >= 0 && m > 0 && m < (int)sizeof(attrs))
        m += snprintf(attrs + m, sizeof(attrs) - m, "count \"%lld\"; ",
                      (long long)count);
    fprintf(f, "%s\t%s\ttranscript\t%lld\t%lld\t%d\t%c\t.\t%s\n",
            seqname, source, (long long)(p1 + 1), (long long)p2, 1000,
            t.strand, attrs);
    for (size_t k = 0; k < t.nex(); k++)
        fprintf(f,
                "%s\t%s\texon\t%lld\t%lld\t%d\t%c\t.\tgene_id \"%s\"; "
                "transcript_id \"%s\"; exon \"%zu\"; \n",
                seqname, source, (long long)(t.e(k, 0) + 1),
                (long long)t.e(k, 1), 1000, t.strand, t.gene_id.c_str(),
                t.tid.c_str(), k + 1);
}

// io/gtf.py FEATURE_INT_COLUMNS truncation mask, FEATURE_COLUMNS order
static const bool FEAT_INT[41] = {
    1, 1, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 0, 1,
    0, 1, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0};

// io/gtf.py write_features feat_row fast path (transcript.cc:362-428)
static inline void write_feat_row(FILE* f, const NTrans& t,
                                  const char* seqname) {
    fprintf(f, "%s\t%s\t%s\t%.6g\t%.6g\t%.6g\t%.6g\t%lld\t%d\t%d\t",
            t.tid.c_str(), t.meta_tid.c_str(), seqname, t.coverage, t.cov2,
            t.abd, t.conf, (long long)t.count1, (int)t.count2,
            (int)t.nex());
    for (int i = 0; i < 41; i++) {
        double v = i < (int)t.feat.size() ? t.feat[i] : 0.0;
        if (FEAT_INT[i]) fprintf(f, "%lld", (long long)v);
        else fprintf(f, "%.6g", v);
        fputc(i == 40 ? '\n' : '\t', f);
    }
}

}  // namespace core_tset

#endif  // ALETSCH_CORE_TSET_H
