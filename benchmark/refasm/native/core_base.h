// core_base.h — foundations of the native per-bundle assembly core.
//
// Bit-exact C++ ports of the Python modules that define the assembly
// semantics (which in turn re-implement the reference, Shao-Group/aletsch):
//   CoverageMap   <- aletsch_tpu/utils/intervals.py  (boost::icl split map,
//                    rnacore/interval_map.{h,cc})
//   seqs helpers  <- aletsch_tpu/utils/seqs.py       (util/util.h:142-335)
//   ChainSet      <- aletsch_tpu/core/chain_set.py   (rnacore/chain_set.{h,cc})
//   PhaseSet      <- aletsch_tpu/core/chain_set.py   (rnacore/phase_set.{h,cc})
//   SpliceGraph   <- aletsch_tpu/core/graph.py       (rnacore/splice_graph.{h,cc},
//                    graph/directed_graph.{h,cc})
//   Bundle        <- aletsch_tpu/core/bundle.py      (rnacore/bundle_base.{h,cc})
//
// Parity rules (docs/NATIVE.md): Python dict insertion order is modelled with
// vectors + index maps; float accumulations are sequential left-to-right
// doubles in the exact order the Python code performs them; sorts are stable.

#pragma once

#include <algorithm>
#include <array>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace core {

typedef int64_t i64;
typedef uint64_t u64;
typedef int32_t i32;

static const double INF = std::numeric_limits<double>::infinity();
static const double SMIN = 1e-8;          // constants.py:84
static const i64 PY_INT_MAX = ((i64)1) << 31;   // decompose.py:29 (1 << 31)

// boundary types (constants.py:10-17)
enum {
    START_BOUNDARY = 1, END_BOUNDARY = 2, LEFT_SPLICE = 3, RIGHT_SPLICE = 4,
    LEFT_RIGHT_SPLICE = 5, MIDDLE_CUT = 6, LEFT_MIXED = 7, RIGHT_MIXED = 8
};
// vertex classification (constants.py:20-36)
enum {
    VT_TRIVIAL = 0, SPLITTABLE_PURE = 4, UNSPLITTABLE_SINGLE = 5,
    TRIVIAL_VERTEX = 7
};

// ---------------------------------------------------------------- config
// Serialized per-protocol parameter subset (config.py); one per bundle plus
// one for the assembler (params[DEFAULT], meta/incubator.py:458).
struct Cfg {
    // ints
    i64 min_junction_support;
    i64 min_subregion_gap;
    i64 min_subregion_length;
    i64 max_reads_partition_gap;
    i64 bridge_dp_solution_size;
    i64 bridge_dp_stack_size;
    i64 bridge_end_relaxing;
    i64 max_group_boundary_distance;
    i64 max_num_exons;
    // doubles
    double min_guaranteed_edge_weight;
    double min_subregion_overlap;
    double normal_junction_threshold;
    double extend_junction_threshold;
    double min_boundary_log_ratio;
    double min_transcript_coverage;
    double max_decompose_error_ratio[8];
};
static const int CFG_NI = 9;
static const int CFG_ND = 14;

inline Cfg cfg_from_arrays(const i64* ci, const double* cd) {
    Cfg c;
    c.min_junction_support = ci[0];
    c.min_subregion_gap = ci[1];
    c.min_subregion_length = ci[2];
    c.max_reads_partition_gap = ci[3];
    c.bridge_dp_solution_size = ci[4];
    c.bridge_dp_stack_size = ci[5];
    c.bridge_end_relaxing = ci[6];
    c.max_group_boundary_distance = ci[7];
    c.max_num_exons = ci[8];
    c.min_guaranteed_edge_weight = cd[0];
    c.min_subregion_overlap = cd[1];
    c.normal_junction_threshold = cd[2];
    c.extend_junction_threshold = cd[3];
    c.min_boundary_log_ratio = cd[4];
    c.min_transcript_coverage = cd[5];
    for (int k = 0; k < 8; k++) c.max_decompose_error_ratio[k] = cd[6 + k];
    return c;
}

// ------------------------------------------------------------ CoverageMap
// utils/intervals.py CoverageMap: coordinate-compressed difference arrays
// with split_interval_map semantics (zero-valued segments absent).
struct CoverageMap {
    // unit-weight events packed as (pos << 1) | (delta < 0): flat i64 sort
    // is ~2x the pair sort (build dominated the native profile); deltas are
    // +-1 everywhere on the pipeline, the weighted vector is the rare path
    std::vector<i64> events;
    std::vector<std::pair<i64, i64>> wevents;  // (pos, delta), |delta| != 1
    bool dirty = false;
    // sorted-prefix watermarks: mutators only append, so build() sorts
    // just the new suffix and inplace_merges it (the full re-sort per
    // rebuild was ~18% of the production DP; delta sums per position
    // commute, so any order of equal positions yields identical output)
    size_t sorted_e = 0, sorted_w = 0;
    // built state
    std::vector<i64> bps;          // breakpoints, len S+1
    std::vector<i64> vals;         // per-segment value, len S
    // present (nonzero) segments
    std::vector<i64> segl, segr, segv;

    void add(i64 l, i64 r, i64 w) {
        if (l >= r || w == 0) return;
        // genomic coordinates are >= 0; shifting negative i64 is UB and
        // would corrupt the packed sort order — fail loudly instead
        assert(l >= 0);
        if (w == 1) {
            events.push_back((i64)((u64)l << 1));
            events.push_back((i64)(((u64)r << 1) | 1));
        } else if (w == -1) {
            events.push_back((i64)(((u64)l << 1) | 1));
            events.push_back((i64)((u64)r << 1));
        } else {
            wevents.push_back({l, w});
            wevents.push_back({r, -w});
        }
        dirty = true;
    }
    // bulk unit-weight pairs (scanner mev/iev arrays); skips l >= r rows
    void add_pairs(const i32* arr, i64 npairs) {
        for (i64 i = 0; i < npairs; i++) {
            i64 l = arr[2 * i], r = arr[2 * i + 1];
            if (l >= r) continue;
            events.push_back(l << 1);
            events.push_back((r << 1) | 1);
        }
        dirty = events.size() > 0 ? true : dirty;
    }
    void combine(const CoverageMap& o) {
        events.insert(events.end(), o.events.begin(), o.events.end());
        wevents.insert(wevents.end(), o.wevents.begin(), o.wevents.end());
        dirty = true;
    }
    void clear() {
        events.clear(); wevents.clear();
        bps.clear(); vals.clear();
        segl.clear(); segr.clear(); segv.clear();
        dirty = false;
        sorted_e = sorted_w = 0;
    }
    void build() {
        if (!dirty) return;
        dirty = false;
        bps.clear(); vals.clear();
        segl.clear(); segr.clear(); segv.clear();
        if (events.empty() && wevents.empty()) return;
        // in-place sorts: events are a multiset, order carries no meaning
        // (delta sums per position commute over ints).  Incremental:
        // sort only the unsorted suffix, merge into the sorted prefix.
        auto wless = [](const std::pair<i64, i64>& a,
                        const std::pair<i64, i64>& b)
                     { return a.first < b.first; };
        if (sorted_e < events.size()) {
            std::sort(events.begin() + sorted_e, events.end());
            if (sorted_e > 0)
                std::inplace_merge(events.begin(),
                                   events.begin() + sorted_e, events.end());
            sorted_e = events.size();
        }
        if (sorted_w < wevents.size()) {
            std::sort(wevents.begin() + sorted_w, wevents.end(), wless);
            if (sorted_w > 0)
                std::inplace_merge(wevents.begin(),
                                   wevents.begin() + sorted_w,
                                   wevents.end(), wless);
            sorted_w = wevents.size();
        }
        i64 run = 0;
        size_t i = 0, j = 0;
        const size_t ne = events.size(), nw = wevents.size();
        while (i < ne || j < nw) {
            i64 p;
            if (i < ne && (j >= nw || (events[i] >> 1) <= wevents[j].first))
                p = events[i] >> 1;
            else
                p = wevents[j].first;
            i64 d = 0;
            while (i < ne && (events[i] >> 1) == p) {
                d += (events[i] & 1) ? -1 : 1;
                i++;
            }
            while (j < nw && wevents[j].first == p) {
                d += wevents[j].second;
                j++;
            }
            bps.push_back(p);
            run += d;
            vals.push_back(run);
        }
        vals.pop_back();              // value of segment [bps[i], bps[i+1])
        for (size_t k = 0; k < vals.size(); k++) {
            if (vals[k] == 0) continue;
            segl.push_back(bps[k]);
            segr.push_back(bps[k + 1]);
            segv.push_back(vals[k]);
        }
    }
    // number of present segments (len(mmap.segments[0]))
    i64 num_segments() { build(); return (i64)segl.size(); }

    i64 find_value(i64 p) {
        build();
        if (bps.empty()) return 0;
        // index of last breakpoint <= p
        auto it = std::upper_bound(bps.begin(), bps.end(), p);
        i64 i = (i64)(it - bps.begin()) - 1;
        if (i < 0 || i >= (i64)vals.size()) return 0;
        return vals[i];
    }
    // present segments fully inside [x, y]: returns [a, b) index range
    void contained(i64 x, i64 y, i64& a, i64& b) {
        build();
        a = (i64)(std::lower_bound(segl.begin(), segl.end(), x) - segl.begin());
        b = (i64)(std::upper_bound(segr.begin(), segr.end(), y) - segr.begin());
        if (a >= b) { a = 0; b = 0; }
    }
    // (ave, dev, max) over [ll, rr): sequential accumulation
    // (utils/intervals.py evaluate_rectangle)
    void evaluate_rectangle(i64 ll, i64 rr, double& ave, double& dev,
                            double& mx) {
        i64 a, b;
        contained(ll, rr, a, b);
        if (a >= b) { ave = 0.0; dev = 1.0; mx = 0.0; return; }
        mx = (double)segv[a];
        double s = 0.0;
        for (i64 i = a; i < b; i++) {
            double w = (double)segv[i];
            if (w > mx) mx = w;
            s += (double)(segr[i] - segl[i]) * w;
        }
        ave = s / (double)(rr - ll);
        double var = 0.0;
        for (i64 i = a; i < b; i++) {
            double d = (double)segv[i] - ave;
            var += (double)(segr[i] - segl[i]) * (d * d);
        }
        dev = std::sqrt(var / (double)(rr - ll));
    }
    double sum_overlap(i64 ll, i64 rr) {
        i64 a, b;
        contained(ll, rr, a, b);
        i64 s = 0;
        for (i64 i = a; i < b; i++) s += (segr[i] - segl[i]) * segv[i];
        return (double)s;
    }
    // maximal runs of contained covered segments (region.cc:34-58)
    std::vector<std::pair<i64, i64>> covered_runs(i64 ll, i64 rr) {
        std::vector<std::pair<i64, i64>> out;
        i64 a, b;
        contained(ll, rr, a, b);
        if (a >= b) return out;
        i64 rl = segl[a], rr2 = segr[a];
        for (i64 i = a + 1; i < b; i++) {
            if (segl[i] != rr2) {
                out.push_back({rl, rr2});
                rl = segl[i];
            }
            rr2 = segr[i];
        }
        out.push_back({rl, rr2});
        return out;
    }
};

// ------------------------------------------------------------ seqs helpers
// utils/seqs.py (util/util.h:142-335)

template <class V>
inline bool check_increasing(const V& x) {
    for (size_t k = 0; k + 1 < x.size(); k++)
        if (x[k] > x[k + 1]) return false;
    return true;
}

// position constants used only internally by compare/merge
enum {
    SQ_IDENTICAL = 0, SQ_FALL_RIGHT = 1, SQ_FALL_LEFT = 2, SQ_CONTAINED = 3,
    SQ_CONTAINING = 4, SQ_EXTEND_RIGHT = 5, SQ_EXTEND_LEFT = 6,
    SQ_NESTED = 7, SQ_NESTING = 8, SQ_CONFLICTING = 9
};

inline i64 bisect_left_vec(const std::vector<i64>& v, i64 x) {
    return (i64)(std::lower_bound(v.begin(), v.end(), x) - v.begin());
}

// compare_sorted (seqs.py:20-76)
inline int compare_sorted(const std::vector<i64>& ref,
                          const std::vector<i64>& qry) {
    assert(ref.size() >= 1 && qry.size() >= 1);
    if (ref.back() < qry.front()) return SQ_FALL_RIGHT;
    if (ref.front() > qry.back()) return SQ_FALL_LEFT;
    i64 kr1 = bisect_left_vec(ref, qry.front());
    i64 kq1 = bisect_left_vec(qry, ref.front());
    assert(kr1 < (i64)ref.size() && kq1 < (i64)qry.size());
    i64 kq2 = bisect_left_vec(qry, ref.back());
    i64 kr2 = bisect_left_vec(ref, qry.back());
    bool r2_end = kr2 >= (i64)ref.size();
    bool q2_end = kq2 >= (i64)qry.size();
    auto identical = [&](i64 x1, i64 x2, i64 y1, i64 y2) -> bool {
        if (x2 - x1 != y2 - y1) return false;
        for (i64 i = 0; i <= x2 - x1; i++)
            if (ref[x1 + i] != qry[y1 + i]) return false;
        return true;
    };
    if (qry[kq1] == ref.front() || ref[kr1] == qry.front()) {
        if (!r2_end && !q2_end) {
            if (ref.back() != qry.back()) return SQ_CONFLICTING;
            if (!identical(kr1, (i64)ref.size() - 1, kq1, (i64)qry.size() - 1))
                return SQ_CONFLICTING;
            if (kr1 == 0 && kq1 == 0) return SQ_IDENTICAL;
            if (kr1 >= 1 && kq1 == 0) return SQ_CONTAINED;
            if (kr1 == 0 && kq1 >= 1) return SQ_CONTAINING;
            assert(false);
        } else if (!r2_end && q2_end) {
            if (!identical(kr1, kr2, kq1, (i64)qry.size() - 1))
                return SQ_CONFLICTING;
            return kq1 == 0 ? SQ_CONTAINED : SQ_EXTEND_LEFT;
        } else if (r2_end && !q2_end) {
            if (!identical(kr1, (i64)ref.size() - 1, kq1, kq2))
                return SQ_CONFLICTING;
            return kr1 == 0 ? SQ_CONTAINING : SQ_EXTEND_RIGHT;
        }
        return SQ_CONFLICTING;
    } else if (ref[kr1] > qry.front() && kr2 == kr1 && !r2_end &&
               ref[kr2] > qry.back()) {
        return SQ_NESTED;
    } else if (qry[kq1] > ref.front() && kq2 == kq1 && !q2_end &&
               qry[kq2] > ref.back()) {
        return SQ_NESTING;
    }
    return SQ_CONFLICTING;
}

// merge_sorted (seqs.py:79-108)
inline bool merge_sorted(const std::vector<i64>& ref,
                         const std::vector<i64>& qry,
                         std::vector<i64>& out) {
    out.clear();
    if (ref.empty()) { out = qry; return true; }
    if (qry.empty()) { out = ref; return true; }
    int t = compare_sorted(ref, qry);
    switch (t) {
        case SQ_CONFLICTING: case SQ_NESTED: case SQ_NESTING:
            return false;
        case SQ_IDENTICAL: case SQ_CONTAINED:
            out = ref; return true;
        case SQ_CONTAINING:
            out = qry; return true;
        case SQ_FALL_RIGHT:
            out = ref;
            out.insert(out.end(), qry.begin(), qry.end());
            return true;
        case SQ_FALL_LEFT:
            out = qry;
            out.insert(out.end(), ref.begin(), ref.end());
            return true;
        case SQ_EXTEND_LEFT: {
            i64 q1 = bisect_left_vec(qry, ref.front());
            assert(qry[q1] == ref.front());
            out.assign(qry.begin(), qry.begin() + q1);
            out.insert(out.end(), ref.begin(), ref.end());
            return true;
        }
        case SQ_EXTEND_RIGHT: {
            i64 q2 = bisect_left_vec(qry, ref.back());
            assert(qry[q2] == ref.back());
            out = ref;
            out.insert(out.end(), qry.begin() + q2 + 1, qry.end());
            return true;
        }
    }
    assert(false);
    return false;
}

// merge_intron_chains (seqs.py:131-145, rnacore/essential.cc:474-483)
inline bool merge_intron_chains(const std::vector<i64>& x,
                                const std::vector<i64>& y,
                                std::vector<i64>& out) {
    out.clear();
    if (x.size() >= 1 && y.size() >= 1 && x.front() > y.front()) return false;
    if (!merge_sorted(x, y, out)) { out.clear(); return false; }
    i64 d = (i64)x.size() + (i64)y.size() - (i64)out.size();
    if (d % 2 != 0) { out.clear(); return false; }
    return true;
}

// consecutive_subset (seqs.py:152-162): start offsets of x inside ref
inline std::vector<i64> consecutive_subset(const std::vector<int>& ref,
                                           const std::vector<int>& x) {
    std::vector<i64> v;
    if (x.empty() || ref.empty() || x.size() > ref.size()) return v;
    for (size_t i = 0; i + x.size() <= ref.size(); i++) {
        if (ref[i] != x[0]) continue;
        bool ok = true;
        for (size_t j = 0; j < x.size(); j++)
            if (ref[i + j] != x[j]) { ok = false; break; }
        if (ok) v.push_back((i64)i);
    }
    return v;
}

// --------------------------------------------------------------- ChainSet
// core/chain_set.py ChainSet (rnacore/chain_set.{h,cc}): groups in insertion
// order (keyed by first coordinate), [c0, c+, c-] counters, hit handles.
struct ChainSet {
    struct Item { std::vector<i64> v; i64 c[3]; };
    std::vector<std::vector<Item>> chains;         // group -> items
    std::unordered_map<i64, int> pmap;             // first coord -> group
    std::unordered_map<i64, std::array<int, 3>> hmap;  // hit -> (g, i, xs)

    static int xs_idx(char x) { return x == '+' ? 1 : (x == '-' ? 2 : 0); }

    void add_counts(const std::vector<i64>& v, const i64* counts) {
        if (v.empty()) return;
        i64 p = v[0];
        auto it = pmap.find(p);
        if (it == pmap.end()) {
            chains.push_back({});
            chains.back().push_back(Item{v, {counts[0], counts[1], counts[2]}});
            pmap[p] = (int)chains.size() - 1;
            return;
        }
        for (auto& item : chains[it->second]) {
            if (item.v == v) {
                item.c[0] += counts[0];
                item.c[1] += counts[1];
                item.c[2] += counts[2];
                return;
            }
        }
        chains[it->second].push_back(
            Item{v, {counts[0], counts[1], counts[2]}});
    }

    void add(const std::vector<i64>& v, i64 h, char xs_char) {
        if (v.empty()) return;
        if (h >= 0 && hmap.count(h)) return;
        int xs = xs_idx(xs_char);
        i64 p = v[0];
        auto it = pmap.find(p);
        if (it == pmap.end()) {
            Item item{v, {0, 0, 0}};
            item.c[xs] = 1;
            chains.push_back({});
            chains.back().push_back(std::move(item));
            int k = (int)chains.size() - 1;
            pmap[p] = k;
            if (h >= 0) hmap[h] = {k, 0, xs};
            return;
        }
        int k = it->second;
        auto& group = chains[k];
        for (size_t i = 0; i < group.size(); i++) {
            if (group[i].v == v) {
                if (h >= 0) hmap[h] = {k, (int)i, xs};
                group[i].c[xs] += 1;
                return;
            }
        }
        Item item{v, {0, 0, 0}};
        item.c[xs] = 1;
        group.push_back(std::move(item));
        if (h >= 0) hmap[h] = {k, (int)group.size() - 1, xs};
    }

    void add_set(const ChainSet& o) {
        for (const auto& group : o.chains)
            for (const auto& item : group)
                add_counts(item.v, item.c);
    }

    void remove(i64 h) {
        auto it = hmap.find(h);
        if (it == hmap.end()) return;
        auto p = it->second;
        hmap.erase(it);
        i64& c = chains[p[0]][p[1]].c[p[2]];
        c -= 1;
        if (c < 0) c = 0;
    }

    bool get_chain(i64 h, std::vector<i64>& out) const {
        out.clear();
        auto it = hmap.find(h);
        if (it == hmap.end()) return false;
        out = chains[it->second[0]][it->second[1]].v;
        return true;
    }

    std::vector<i64> get_splices() const {
        std::set<i64> s;
        for (const auto& group : chains)
            for (const auto& item : group) {
                if (item.c[0] + item.c[1] + item.c[2] <= 0) continue;
                for (i64 x : item.v) s.insert(x);
            }
        return std::vector<i64>(s.begin(), s.end());
    }
};

// core/chain_set.py PhaseSet (rnacore/phase_set.{h,cc}); consumption is
// order-insensitive (counts summed, HyperSet sorts), so a sorted map is fine.
struct PhaseSet {
    std::map<std::vector<i64>, i64> pmap;
    void add(const std::vector<i64>& v, i64 c) {
        if (v.empty()) return;
        assert(v.size() % 2 == 0);
        pmap[v] += c;
    }
    void combine(const PhaseSet& o) {
        for (const auto& kv : o.pmap) pmap[kv.first] += kv.second;
    }
    // phase_set.cc:50-67
    void project_boundaries(const std::map<i64, i64>& smap,
                            const std::map<i64, i64>& tmap) {
        std::map<std::vector<i64>, i64> nw;
        for (const auto& kv : pmap) {
            std::vector<i64> v = kv.first;
            auto si = smap.find(v.front());
            if (si != smap.end()) v.front() = si->second;
            auto ti = tmap.find(v.back());
            if (ti != tmap.end()) v.back() = ti->second;
            nw[v] += kv.second;
        }
        pmap.swap(nw);
    }
};

// ------------------------------------------------------------ SpliceGraph
// core/graph.py: insertion-ordered adjacency with O(1) removal (Python dict
// semantics), parallel edges, edge moves, eid-ordered edges().

struct VertexInfo {
    i64 lpos = 0, rpos = 0;
    double stddev = 1.0;
    double maxcov = 0.0;
    i64 length = 0;
    int type = 0;
    bool regional = false;
    double boundary_loss1 = 0.0, boundary_loss2 = 0.0, boundary_loss3 = 0.0;
    double boundary_merged_loss = 0.0;
    i64 unbridge_leaving_count = 0;
    double unbridge_leaving_ratio = 0.0;
    i64 unbridge_coming_count = 0;
    double unbridge_coming_ratio = 0.0;
};

struct EdgeInfo {
    double weight = 0.0;
    int strand = 0;              // 0 unknown, 1 '+', 2 '-'
    i64 length = 0;
    i64 count = 0;               // number of supporting samples
    double abd = 0.0;
    double confidence = 0.0;
    std::vector<int> samples;    // sorted unique sample ids
    std::map<int, double> spAbd; // sample -> abundance (sorted)

    bool has_sample(int s) const {
        return std::binary_search(samples.begin(), samples.end(), s);
    }
    void add_sample(int s) {
        auto it = std::lower_bound(samples.begin(), samples.end(), s);
        if (it == samples.end() || *it != s) samples.insert(it, s);
    }
    static std::vector<int> intersect(const std::vector<int>& a,
                                      const std::vector<int>& b) {
        std::vector<int> out;
        std::set_intersection(a.begin(), a.end(), b.begin(), b.end(),
                              std::back_inserter(out));
        return out;
    }
};

struct GEdge {
    int s = -1, t = -1;
    i64 eid = -1;
    bool alive = false;
    double wrt = 0.0;
    EdgeInfo info;
    // adjacency links (source out-list, target in-list)
    GEdge* onext = nullptr; GEdge* oprev = nullptr;
    GEdge* inext = nullptr; GEdge* iprev = nullptr;
    // scallop super-edge bookkeeping (decompose.py mev/med/mei)
    std::vector<int> mev;
    double med = 0.0;
    i64 mei = 0;
    int si = -1;                 // scallop edge index (e2i)
};

struct AdjList {
    GEdge* head = nullptr;
    GEdge* tail = nullptr;
    int n = 0;
};

struct SpliceGraph {
    char strand = '.';
    i64 reads = 0;
    i64 subgraph = 1;
    std::deque<GEdge> pool;                       // by eid; deque keeps
                                                  // addresses stable and
                                                  // allocates in chunks
    std::vector<VertexInfo> vinfo;
    std::vector<double> vwrt;
    std::vector<AdjList> vin, vout;
    // pos -> vertex as sorted flat arrays (vertex order is genomic, so keys
    // arrive ascending; last-wins on duplicates = std::map overwrite)
    struct PosIndex {
        std::vector<i64> keys;
        std::vector<int> vals;
        void clear() { keys.clear(); vals.clear(); }
        void insert_ascending(i64 k, int v) {
            if (!keys.empty() && keys.back() == k) { vals.back() = v; return; }
            if (!keys.empty() && keys.back() > k) {   // defensive: keep sorted
                auto it = std::lower_bound(keys.begin(), keys.end(), k);
                size_t i = (size_t)(it - keys.begin());
                if (it != keys.end() && *it == k) { vals[i] = v; return; }
                keys.insert(it, k);
                vals.insert(vals.begin() + (long)i, v);
                return;
            }
            keys.push_back(k);
            vals.push_back(v);
        }
        int find(i64 k) const {
            auto it = std::lower_bound(keys.begin(), keys.end(), k);
            if (it == keys.end() || *it != k) return -1;
            return vals[(size_t)(it - keys.begin())];
        }
    };
    PosIndex lindex, rindex;
    std::vector<i64> llist;                       // interior lpos (sorted)
    bool has_index = false;

    int add_vertex() {
        vinfo.push_back(VertexInfo());
        vwrt.push_back(0.0);
        vin.push_back(AdjList());
        vout.push_back(AdjList());
        return (int)vinfo.size() - 1;
    }
    int num_vertices() const { return (int)vinfo.size(); }

    // -------- adjacency list plumbing
    static void link_out(AdjList& a, GEdge* e) {
        e->oprev = a.tail; e->onext = nullptr;
        if (a.tail) a.tail->onext = e; else a.head = e;
        a.tail = e; a.n++;
    }
    static void unlink_out(AdjList& a, GEdge* e) {
        if (e->oprev) e->oprev->onext = e->onext; else a.head = e->onext;
        if (e->onext) e->onext->oprev = e->oprev; else a.tail = e->oprev;
        e->oprev = e->onext = nullptr; a.n--;
    }
    static void link_in(AdjList& a, GEdge* e) {
        e->iprev = a.tail; e->inext = nullptr;
        if (a.tail) a.tail->inext = e; else a.head = e;
        a.tail = e; a.n++;
    }
    static void unlink_in(AdjList& a, GEdge* e) {
        if (e->iprev) e->iprev->inext = e->inext; else a.head = e->inext;
        if (e->inext) e->inext->iprev = e->iprev; else a.tail = e->iprev;
        e->iprev = e->inext = nullptr; a.n--;
    }

    GEdge* add_edge(int s, int t) {
        pool.emplace_back();
        GEdge* e = &pool.back();
        e->eid = (i64)pool.size() - 1;
        e->s = s; e->t = t; e->alive = true;
        link_out(vout[s], e);
        link_in(vin[t], e);
        return e;
    }
    void remove_edge(GEdge* e) {
        unlink_out(vout[e->s], e);
        unlink_in(vin[e->t], e);
        e->alive = false;
    }
    // directed_graph::move_edge: del + re-append (tail position)
    void move_edge(GEdge* e, int s, int t) {
        unlink_out(vout[e->s], e);
        unlink_in(vin[e->t], e);
        e->s = s; e->t = t;
        link_out(vout[s], e);
        link_in(vin[t], e);
    }
    void clear_vertex(int v) {
        // list(in) + list(out), then remove each
        std::vector<GEdge*> es;
        for (GEdge* e = vin[v].head; e; e = e->inext) es.push_back(e);
        for (GEdge* e = vout[v].head; e; e = e->onext) es.push_back(e);
        for (GEdge* e : es) remove_edge(e);
    }
    GEdge* edge(int s, int t) const {
        for (GEdge* e = vout[s].head; e; e = e->onext)
            if (e->t == t) return e;
        return nullptr;
    }
    // all live edges in eid (creation) order
    std::vector<GEdge*> edges() const {
        std::vector<GEdge*> out;
        for (const auto& ge : pool)
            if (ge.alive) out.push_back(const_cast<GEdge*>(&ge));
        return out;
    }
    i64 num_edges() const {
        i64 n = 0;
        for (const auto& ge : pool) if (ge.alive) n++;
        return n;
    }
    int in_degree(int v) const { return vin[v].n; }
    int out_degree(int v) const { return vout[v].n; }
    int degree(int v) const { return vin[v].n + vout[v].n; }

    double get_in_weights(int v) const {
        double s = 0.0;
        for (GEdge* e = vin[v].head; e; e = e->inext) s += e->wrt;
        return s;
    }
    double get_out_weights(int v) const {
        double s = 0.0;
        for (GEdge* e = vout[v].head; e; e = e->onext) s += e->wrt;
        return s;
    }

    // deep copy with eids renumbered in edges() order (graph.py copy())
    void copy_into(SpliceGraph& g) const {
        g.strand = strand;
        g.reads = reads;
        g.subgraph = subgraph;
        for (int v = 0; v < num_vertices(); v++) {
            g.add_vertex();
            g.vwrt[v] = vwrt[v];
            g.vinfo[v] = vinfo[v];
        }
        for (GEdge* e : edges()) {
            GEdge* f = g.add_edge(e->s, e->t);
            f->wrt = e->wrt;
            f->info = e->info;
        }
        g.lindex = lindex;
        g.rindex = rindex;
        g.has_index = has_index;
        g.llist = llist;    // only consulted with the size guard below
    }

    // splice_graph.cc:1087-1099
    void build_vertex_index() {
        lindex.clear(); rindex.clear();
        int n = num_vertices() - 1;
        for (int i = 0; i <= n; i++) {
            const VertexInfo& v = vinfo[i];
            if (i != 0) lindex.insert_ascending(v.lpos, i);
            if (i != n) rindex.insert_ascending(v.rpos, i);
        }
        llist.clear();
        for (int i = 1; i < n; i++) llist.push_back(vinfo[i].lpos);
        has_index = true;
    }

    // splice_graph.cc:1166 (graph.py locate_vertex with the llist guard)
    int locate_vertex(i64 p) const {
        if (has_index && (i64)llist.size() == (i64)num_vertices() - 2) {
            i64 i = (i64)(std::upper_bound(llist.begin(), llist.end(), p)
                          - llist.begin());
            if (i == 0) return -1;
            const VertexInfo& v = vinfo[i];
            return (v.lpos <= p && p < v.rpos) ? (int)i : -1;
        }
        i64 a = 1, b = (i64)num_vertices() - 1;
        while (a < b) {
            i64 m = (a + b) / 2;   // both positive: same as Python floordiv
            const VertexInfo& v = vinfo[m];
            if (v.lpos <= p && p < v.rpos) { a = b = m; break; }
            if (p < v.lpos) b = m; else a = m + 1;
        }
        i64 m = b;
        if (m >= (i64)num_vertices()) return -1;
        const VertexInfo& v = vinfo[m];
        if (v.lpos <= p && p < v.rpos) return (int)m;
        return -1;
    }
    int locate_lbound(i64 p) const { return lindex.find(p); }
    int locate_rbound(i64 p) const { return rindex.find(p); }

    // Kahn in vertex-id order (graph.py topological_sort)
    std::vector<int> topological_sort() const {
        int n = num_vertices();
        std::vector<int> vd(n), q;
        for (int i = 0; i < n; i++) vd[i] = in_degree(i);
        for (int i = 0; i < n; i++) if (vd[i] == 0) q.push_back(i);
        std::vector<int> v;
        size_t k = 0;
        while (k < q.size()) {
            int x = q[k++];
            v.push_back(x);
            for (GEdge* e = vout[x].head; e; e = e->onext) {
                if (--vd[e->t] == 0) q.push_back(e->t);
            }
        }
        return v;
    }

    // bottleneck max path DP (graph.py compute_maximum_st_path_w,
    // splice_graph.cc:819-885); returns weight (-1 unreachable) and edges
    double compute_maximum_path_w(std::vector<GEdge*>& path) const {
        return compute_maximum_st_path_w(0, num_vertices() - 1, path);
    }
    double compute_maximum_st_path_w(int ss, int tt,
                                     std::vector<GEdge*>& path) const {
        int n = num_vertices();
        std::vector<double> table(n, -1.0);
        std::vector<GEdge*> back(n, nullptr);
        std::vector<int> tp = topological_sort();
        std::vector<int> pos(n, 0);
        for (int i = 0; i < (int)tp.size(); i++) pos[tp[i]] = i;
        int ssi = pos[ss], tti = pos[tt];
        table[ss] = INF;
        for (int ii = ssi + 1; ii <= tti; ii++) {
            int i = tp[ii];
            if (degree(i) == 0) continue;
            double max_abd = 0.0;
            GEdge* max_edge = nullptr;
            for (GEdge* e = vin[i].head; e; e = e->inext) {
                int s = e->s;
                if (table[s] <= -1) continue;
                double ww = std::min(e->wrt, table[s]);
                if (ww >= max_abd) { max_abd = ww; max_edge = e; }
            }
            if (max_edge == nullptr) continue;
            back[i] = max_edge;
            table[i] = max_abd;
        }
        path.clear();
        int x = tt;
        while (true) {
            GEdge* e = back[x];
            if (e == nullptr) break;
            path.push_back(e);
            x = e->s;
        }
        std::reverse(path.begin(), path.end());
        return table[tt];
    }

    // strand utilities (graph.py:362-409)
    void get_strand_degree(int i, i64 vs[6]) const {
        for (int k = 0; k < 6; k++) vs[k] = 0;
        for (GEdge* e = vin[i].head; e; e = e->inext) vs[e->info.strand]++;
        for (GEdge* e = vout[i].head; e; e = e->onext) vs[e->info.strand + 3]++;
    }
    bool mixed_strand_vertex(int i) const {
        i64 v[6];
        get_strand_degree(i, v);
        return (v[1] + v[4]) >= 1 && (v[2] + v[5]) >= 1;
    }
    // splice_graph.cc:1338-1373
    void extend_strands() {
        for (GEdge* e : edges()) {
            int sd = e->info.strand;
            int s = e->s, t = e->t;
            i64 p1 = vinfo[s].rpos, p2 = vinfo[t].lpos;
            if (p1 >= p2) continue;
            if (s + 2 != t) continue;
            if (e->wrt <= vwrt[s + 1]) continue;
            if (vinfo[s + 1].lpos != p1 || vinfo[s + 1].rpos != p2) continue;
            GEdge* e1 = edge(s, s + 1);
            GEdge* e2 = edge(s + 1, t);
            if (e1 && e1->info.strand == 0) e1->info.strand = sd;
            if (e2 && e2->info.strand == 0) e2->info.strand = sd;
        }
    }
};

// ----------------------------------------------------------------- Bundle
// core/bundle.py BundleBase + meta/bundle.py Bundle, built from the native
// scanner's flushed arrays (io/bam_native.py ScanBundle layout; row = 25
// int32: decoder fields + routed strand[22] + crc[23] + hid[24]).
struct HitRow {
    i64 pos, rpos, mpos;
    i64 isize;
    i64 flag, nm, hid;
    char xs, strand;
};

struct Bundle {
    i64 tid = -1;
    i64 lpos = (i64)1 << 30;
    i64 rpos = 0;
    char strand = '.';
    int sample_id = -1;
    i64 insert_low = 0, insert_high = 0;
    Cfg cfg;                               // per-protocol parameters
    std::vector<HitRow> hits;
    std::vector<std::array<i64, 3>> frgs;  // [h1, h2, type]
    ChainSet hcst, fcst;
    CoverageMap mmap, imap;
    // scanner arrays for the cluster-engine export (zero-copy)
    const i32* fixed = nullptr;            // 25 per row
    const i32* coords = nullptr;
    i64 nh = 0;

    void init_from_scan(const i32* fixed_rows, i64 n, const i32* coord_pool,
                        const i32* mev, i64 n_mev_pairs,
                        const i32* iev, i64 n_iev_pairs,
                        const i32* frg_pairs, i64 n_frg) {
        fixed = fixed_rows;
        coords = coord_pool;
        nh = n;
        hits.resize(n);
        for (i64 j = 0; j < n; j++) {
            const i32* row = fixed_rows + 25 * j;
            HitRow& h = hits[j];
            h.pos = row[1]; h.rpos = row[2]; h.mpos = row[6];
            h.isize = row[7]; h.flag = row[4]; h.nm = row[15];
            h.hid = row[24];
            h.xs = (char)row[12];
            h.strand = (char)row[22];
        }
        mmap.add_pairs(mev, n_mev_pairs);
        imap.add_pairs(iev, n_iev_pairs);
        frgs.clear();
        for (i64 k = 0; k < n_frg; k++)
            frgs.push_back({(i64)frg_pairs[2 * k], (i64)frg_pairs[2 * k + 1],
                            (i64)0});
        // per-hit chains (materialize_bundle: coords slice at
        // row[17] + 2*row[18], length row[19])
        std::vector<i64> ch;
        for (i64 j = 0; j < n; j++) {
            const i32* row = fixed_rows + 25 * j;
            i64 sc = row[19];
            if (!sc) continue;
            i64 off = (i64)row[17] + 2 * (i64)row[18];
            ch.assign(coord_pool + off, coord_pool + off + sc);
            hcst.add(ch, j, hits[j].xs);
        }
    }

    // meta/bundle.py copy_meta_information
    void copy_meta_information(const Bundle& bb) {
        strand = bb.strand;
        tid = bb.tid;
        lpos = bb.lpos;
        rpos = bb.rpos;
    }
    // meta/bundle.py combine (meta/bundle.cc:90-107)
    void combine(const Bundle& bb, bool combine_map) {
        assert(strand == bb.strand && tid == bb.tid);
        lpos = std::min(lpos, bb.lpos);
        rpos = std::max(rpos, bb.rpos);
        hcst.add_set(bb.hcst);
        fcst.add_set(bb.fcst);
        if (combine_map) {
            mmap.combine(bb.mmap);
            imap.combine(bb.imap);
        }
    }
    void clear() {
        hits.clear(); frgs.clear();
        hcst = ChainSet(); fcst = ChainSet();
        mmap.clear(); imap.clear();
    }

    i64 count_unbridged() const {
        i64 n = 0;
        for (const auto& f : frgs) if (f[2] == 0) n++;
        return n;
    }

    // bundle_base.cc:420-507 (core/bundle.py update_bridges)
    i64 update_bridges(const std::vector<int>& frlist,
                       const std::vector<i64>& chain, int strand012) {
        i64 cnt = 0;
        for (int k : frlist) {
            assert(frgs[k][2] == 0);
            const HitRow& h1 = hits[frgs[k][0]];
            const HitRow& h2 = hits[frgs[k][1]];
            std::vector<i64> v1;
            v1.push_back(h1.rpos);
            v1.insert(v1.end(), chain.begin(), chain.end());
            v1.push_back(h2.pos);
            if (h1.rpos < h2.pos && !check_increasing(v1)) continue;
            cnt++;
            if (chain.empty()) {
                frgs[k][2] = 1;
            } else {
                char s = '.';
                if (h1.xs != '.') s = h1.xs;
                if (h2.xs != '.') s = h2.xs;
                if (h1.xs != '.' && h2.xs != '.' && h1.xs != h2.xs) s = '.';
                char ss = '.';
                if (strand012 == 1) ss = '+';
                if (strand012 == 2) ss = '-';
                frgs[k][2] = 2;
                if (s == ss) fcst.add(chain, k, ss);
                else if (s != '.' && ss == '.') fcst.add(chain, k, s);
                else if (ss != '.' && s == '.') fcst.add(chain, k, ss);
                else fcst.add(chain, k, '.');
            }
            for (size_t j = 0; j + 1 < v1.size(); j += 2) {
                i64 p1 = v1[j], p2 = v1[j + 1];
                if (p1 >= p2) continue;
                mmap.add(p1, p2, 1);
            }
        }
        return cnt;
    }

    // bundle_base.cc:338-418 (core/bundle.py build_phase_set)
    void build_phase_set(PhaseSet& ps, const SpliceGraph& gr) const {
        std::vector<int> fb(hits.size(), -1);
        std::vector<i64> v1, v2, vv, xy;
        for (size_t i = 0; i < frgs.size(); i++) {
            const auto& f = frgs[i];
            if (f[2] <= -1) continue;
            i64 h1 = f[0], h2 = f[1];
            if (f[2] == 0) {
                fb[h1] = 0;
                fb[h2] = 0;
                continue;
            }
            int u1 = gr.locate_vertex(hits[h1].pos);
            int u2 = gr.locate_vertex(hits[h2].rpos - 1);
            if (u1 < 0 || u2 < 0) continue;
            i64 p1 = gr.vinfo[u1].lpos;
            i64 p2 = gr.vinfo[u2].rpos;
            hcst.get_chain(h1, v1);
            hcst.get_chain(h2, v2);
            xy.clear();
            if (f[2] == 1) {
                if (!merge_intron_chains(v1, v2, xy)) continue;
            }
            if (f[2] >= 2) {
                fcst.get_chain((i64)i, vv);
                xy = v1;
                xy.insert(xy.end(), vv.begin(), vv.end());
                xy.insert(xy.end(), v2.begin(), v2.end());
            }
            xy.insert(xy.begin(), p1);
            xy.push_back(p2);
            if (!check_increasing(xy)) continue;
            fb[h1] = 1;
            fb[h2] = 1;
            ps.add(xy, 1);
        }
        for (size_t i = 0; i < hits.size(); i++) {
            if (fb[i] >= 0 || hits[i].hid < 0) continue;
            int u1 = gr.locate_vertex(hits[i].pos);
            int u2 = gr.locate_vertex(hits[i].rpos - 1);
            if (u1 < 0 || u2 < 0) continue;
            i64 p1 = gr.vinfo[u1].lpos;
            i64 p2 = gr.vinfo[u2].rpos;
            hcst.get_chain((i64)i, v1);
            xy.clear();
            xy.push_back(p1);
            xy.insert(xy.end(), v1.begin(), v1.end());
            xy.push_back(p2);
            if (!check_increasing(xy)) continue;
            ps.add(xy, 1);
        }
    }
};

}  // namespace core
