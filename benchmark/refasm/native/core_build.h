// core_build.h — bundle -> splice graph construction and graph revision.
//
// Ports of:
//   regions        <- aletsch_tpu/core/regions.py      (rnacore/region.{h,cc})
//   GraphBuilder   <- aletsch_tpu/core/graph_builder.py (rnacore/graph_builder.{h,cc})
//   graph_reviser  <- aletsch_tpu/core/graph_reviser.py (rnacore/graph_reviser.cc:899-1377)
//   essential      <- aletsch_tpu/core/essential.py     (rnacore/essential.{h,cc})

#pragma once

#include "core_base.h"

namespace core {

// ----------------------------------------------------------- essential.py

// essential.cc:436-446
inline bool check_continuous_vertices(const SpliceGraph& gr, int x, int y) {
    if (x >= y) return true;
    for (int i = x; i < y; i++) {
        if (gr.edge(i, i + 1) == nullptr) return false;
        if (gr.vinfo[i].rpos != gr.vinfo[i + 1].lpos) return false;
    }
    return true;
}

// essential.cc:448-459
inline bool check_valid_path(const SpliceGraph& gr, const std::vector<int>& vv) {
    int n = gr.num_vertices() - 1;
    for (size_t k = 0; k + 1 < vv.size(); k++) {
        if (vv[k] < 0 || vv[k] > n || vv[k + 1] < 0 || vv[k + 1] > n)
            return false;
        if (gr.edge(vv[k], vv[k + 1]) == nullptr) return false;
    }
    return true;
}

// essential.cc:321-366
inline bool build_path_from_exon_coordinates(const SpliceGraph& gr,
                                             const std::vector<i64>& v,
                                             std::vector<int>& vv) {
    vv.clear();
    if (v.empty()) return true;
    assert(v.size() % 2 == 0);
    size_t n = v.size() / 2;
    std::vector<std::pair<int, int>> pp;
    for (size_t k = 0; k < n; k++) {
        i64 p = v[2 * k], q = v[2 * k + 1];
        if (p < 0 || q < 0 || p >= q) return false;
        int a = gr.locate_lbound(p);
        int b = gr.locate_rbound(q);
        if (a < 0 || b < 0) return false;
        pp.push_back({a, b});
    }
    for (auto& ab : pp) {
        if (ab.first > ab.second) { vv.clear(); return false; }
        if (!check_continuous_vertices(gr, ab.first, ab.second)) {
            vv.clear();
            return false;
        }
        for (int x = ab.first; x <= ab.second; x++) vv.push_back(x);
    }
    for (size_t i = 0; i + 1 < vv.size(); i++)
        if (vv[i] >= vv[i + 1]) { vv.clear(); return false; }
    return true;
}

// essential.cc:148-162
inline void build_intron_coordinates_from_path(const SpliceGraph& gr,
                                               const std::vector<int>& v,
                                               std::vector<i64>& vv) {
    vv.clear();
    for (size_t i = 0; i + 1 < v.size(); i++) {
        i64 pp = gr.vinfo[v[i]].rpos;
        i64 qq = gr.vinfo[v[i + 1]].lpos;
        assert(pp <= qq);
        if (pp == qq) continue;
        vv.push_back(pp);
        vv.push_back(qq);
    }
}

// essential.cc:164-200: 0 unknown / 1 '+' / 2 '-' / -1 invalid
inline int check_strand_from_intron_coordinates(const SpliceGraph& gr,
                                                const std::vector<i64>& v) {
    assert(v.size() % 2 == 0);
    if (v.empty()) return 0;
    bool b1 = false, b2 = false;
    for (size_t k = 0; k < v.size() / 2; k++) {
        i64 p = v[2 * k], q = v[2 * k + 1];
        if (p >= q) return -1;
        int kp = gr.locate_rbound(p);
        int kq = gr.locate_lbound(q);
        if (kp < 0 || kq < 0) return -1;
        GEdge* e = gr.edge(kp, kq);
        if (e == nullptr) return -1;
        if (e->info.strand == 1) b1 = true;
        if (e->info.strand == 2) b2 = true;
    }
    if (b1 && b2) return -1;
    if (b1) return 1;
    if (b2) return 2;
    return 0;
}

// essential.cc:101-113
inline i64 get_total_length_of_introns(const std::vector<i64>& chain) {
    i64 x = 0;
    for (size_t k = 0; k < chain.size() / 2; k++) {
        i64 p = chain[2 * k], q = chain[2 * k + 1];
        assert(p < q);
        x += q - p;
    }
    return x;
}

// ------------------------------------------------------------- regions.py

struct PartialExon {
    i64 lpos, rpos;
    int ltype, rtype;
    double ave = 0.0, dev = 1.0, max = 0.0;
    double pvalue = 1.0;
};

struct Junction {
    i64 lpos, rpos;
    i64 count = 0;
    char strand = '.';
    i64 xs0 = 0, xs1 = 0, xs2 = 0;
    i64 nm = 0;
    int lexon = -1, rexon = -1;
};

// region.cc:88-107
inline bool empty_subregion(CoverageMap& mmap, i64 p1, i64 p2,
                            const Cfg& cfg) {
    if (p2 - p1 < cfg.min_subregion_length) return true;
    double s = mmap.sum_overlap(p1, p2);
    if (s <= 0) return true;
    double ratio = s / (double)(p2 - p1);
    return ratio < cfg.min_subregion_overlap;
}

// region.cc:34-169 (regions.py build_region_pexons)
inline void build_region_pexons(i64 lpos, i64 rpos, int ltype, int rtype,
                                CoverageMap& mmap, const Cfg& cfg,
                                std::vector<PartialExon>& out) {
    std::vector<std::pair<i64, i64>> runs = mmap.covered_runs(lpos, rpos);

    if (ltype == RIGHT_SPLICE && rtype == LEFT_SPLICE) {
        std::vector<std::pair<i64, i64>> filled;
        i64 p = lpos;
        for (auto& r : runs) {
            if (r.first - p <= cfg.min_subregion_gap)
                filled.push_back({p, r.first});
            p = r.second;
        }
        if (p < rpos && rpos - p <= cfg.min_subregion_gap)
            filled.push_back({p, rpos});
        if (!filled.empty()) {
            std::vector<std::pair<i64, i64>> merged(runs);
            merged.insert(merged.end(), filled.begin(), filled.end());
            std::sort(merged.begin(), merged.end());
            runs.clear();
            for (auto& ab : merged) {
                if (!runs.empty() && runs.back().second >= ab.first)
                    runs.back().second = std::max(runs.back().second, ab.second);
                else
                    runs.push_back(ab);
            }
        }
    }

    assert(lpos < rpos);

    if (runs.empty() && rpos == lpos + 1 &&
        (ltype == END_BOUNDARY || rtype == START_BOUNDARY)) {
        PartialExon pe{lpos, rpos, ltype, rtype};
        pe.ave = cfg.min_guaranteed_edge_weight;
        pe.dev = 1.0;
        out.push_back(pe);
        return;
    }

    if (!runs.empty() && runs[0].first == lpos && runs[0].second == rpos) {
        PartialExon pe{lpos, rpos, ltype, rtype};
        mmap.evaluate_rectangle(lpos, rpos, pe.ave, pe.dev, pe.max);
        out.push_back(pe);
        return;
    }

    auto covers = [&runs](i64 p, bool left) {
        for (auto& ab : runs) {
            if (left) { if (ab.first <= p && p < ab.second) return true; }
            else      { if (ab.first < p && p <= ab.second) return true; }
        }
        return false;
    };

    if (ltype == RIGHT_SPLICE && !covers(lpos, true)) {
        PartialExon pe{lpos, lpos + 1, ltype, END_BOUNDARY};
        pe.ave = cfg.min_guaranteed_edge_weight;
        pe.dev = 1.0;
        out.push_back(pe);
    }

    for (auto& ab : runs) {
        i64 p1 = ab.first, p2 = ab.second;
        bool b = empty_subregion(mmap, p1, p2, cfg);
        if (p1 == lpos && ltype == RIGHT_SPLICE) b = false;
        if (p2 == rpos && rtype == LEFT_SPLICE) b = false;
        if (b) continue;
        int lt = (p1 == lpos) ? ltype : START_BOUNDARY;
        int rt = (p2 == rpos) ? rtype : END_BOUNDARY;
        PartialExon pe{p1, p2, lt, rt};
        mmap.evaluate_rectangle(p1, p2, pe.ave, pe.dev, pe.max);
        out.push_back(pe);
    }

    if (rtype == LEFT_SPLICE && !covers(rpos, false)) {
        PartialExon pe{rpos - 1, rpos, START_BOUNDARY, rtype};
        pe.ave = cfg.min_guaranteed_edge_weight;
        pe.dev = 1.0;
        out.push_back(pe);
    }
}

// -------------------------------------------------------- graph_builder.py

// graph_reviser.cc:899-914 (graph_builder.py refine_splice_graph)
inline void refine_splice_graph(SpliceGraph& gr) {
    while (true) {
        bool b = false;
        for (int i = 1; i < gr.num_vertices() - 1; i++) {
            if (gr.degree(i) == 0) continue;
            if (gr.in_degree(i) >= 1 && gr.out_degree(i) >= 1) continue;
            gr.clear_vertex(i);
            b = true;
        }
        if (!b) break;
    }
}

struct GraphBuilder {
    Bundle& bd;
    const Cfg& cfg;
    std::vector<Junction> junctions;
    std::vector<PartialExon> pexons;
    std::vector<bool> regional;

    GraphBuilder(Bundle& b, const Cfg& c) : bd(b), cfg(c) {}

    void build(SpliceGraph& gr) {
        build_junctions();
        remove_opposite_junctions();
        build_regions_and_pexons();
        classify_partial_exons();
        link_partial_exons();
        build_splice_graph(gr);
        refine_splice_graph(gr);
    }

    // graph_builder.cc:46-125
    void build_junctions() {
        ChainSet jcst;
        std::vector<i64> pair(2);
        for (int which = 0; which < 2; which++) {
            const ChainSet& cst = which == 0 ? bd.hcst : bd.fcst;
            for (const auto& group : cst.chains) {
                for (const auto& item : group) {
                    const std::vector<i64>& v = item.v;
                    if (v.empty() || v.size() % 2 != 0) continue;
                    for (size_t k = 0; k < v.size() / 2; k++) {
                        pair[0] = v[2 * k];
                        pair[1] = v[2 * k + 1];
                        jcst.add_counts(pair, item.c);
                    }
                }
            }
        }
        junctions.clear();
        for (const auto& group : jcst.chains) {
            for (const auto& item : group) {
                const std::vector<i64>& v = item.v;
                if (v.size() != 2 || v[0] >= v[1]) continue;
                i64 count = item.c[0] + item.c[1] + item.c[2];
                if (count < cfg.min_junction_support) continue;
                Junction jc;
                jc.lpos = v[0];
                jc.rpos = v[1];
                jc.count = count;
                jc.xs0 = item.c[0];
                jc.xs1 = item.c[1];
                jc.xs2 = item.c[2];
                if (jc.xs1 > jc.xs2) jc.strand = '+';
                else if (jc.xs1 < jc.xs2) jc.strand = '-';
                else jc.strand = '.';
                junctions.push_back(jc);
            }
        }
    }

    // graph_builder.cc:128-175
    void remove_opposite_junctions() {
        std::set<size_t> fb;
        auto& js = junctions;
        for (size_t i = 0; i < js.size(); i++) {
            if (fb.count(i)) continue;
            for (size_t j = i + 1; j < js.size(); j++) {
                if (fb.count(j)) continue;
                Junction& x = js[i];
                Junction& y = js[j];
                if (x.strand == y.strand) continue;
                double threshold = cfg.normal_junction_threshold;
                i64 z = (x.rpos - x.lpos) - (y.rpos - y.lpos);
                if (z == 0 || x.lpos == y.lpos || x.rpos == y.rpos)
                    threshold = cfg.extend_junction_threshold;
                i64 d = std::llabs(x.lpos - y.lpos) + std::llabs(x.rpos - y.rpos);
                if ((double)d > threshold) continue;
                double xr = (double)x.nm / (double)x.count;
                double yr = (double)y.nm / (double)y.count;
                if (x.count > y.count && xr < yr) fb.insert(j);
                if (x.count < y.count && xr > yr) fb.insert(i);
            }
        }
        std::vector<Junction> keep;
        for (size_t i = 0; i < js.size(); i++)
            if (!fb.count(i)) keep.push_back(js[i]);
        junctions.swap(keep);
    }

    // graph_builder.cc:177-242
    void build_regions_and_pexons() {
        std::map<i64, int> s;
        s[bd.lpos] = START_BOUNDARY;
        s[bd.rpos] = END_BOUNDARY;
        for (const auto& jc : junctions) {
            i64 l = jc.lpos, r = jc.rpos;
            auto li = s.find(l);
            if (li == s.end()) s[l] = LEFT_SPLICE;
            else if (li->second == RIGHT_SPLICE) li->second = LEFT_RIGHT_SPLICE;
            auto ri = s.find(r);
            if (ri == s.end()) s[r] = RIGHT_SPLICE;
            else if (ri->second == LEFT_SPLICE) ri->second = LEFT_RIGHT_SPLICE;
        }
        std::vector<std::pair<i64, int>> v(s.begin(), s.end());
        pexons.clear();
        regional.clear();
        std::vector<PartialExon> pes;
        for (size_t k = 0; k + 1 < v.size(); k++) {
            i64 l = v[k].first;
            int ltype = v[k].second;
            i64 r = v[k + 1].first;
            int rtype = v[k + 1].second;
            if (ltype == LEFT_RIGHT_SPLICE) ltype = RIGHT_SPLICE;
            if (rtype == LEFT_RIGHT_SPLICE) rtype = LEFT_SPLICE;
            pes.clear();
            build_region_pexons(l, r, ltype, rtype, bd.mmap, cfg, pes);
            for (const auto& pe : pes) {
                pexons.push_back(pe);
                bool reg = (pe.lpos != bd.lpos || pe.rpos != bd.rpos) &&
                           pe.ltype == START_BOUNDARY &&
                           pe.rtype == END_BOUNDARY;
                regional.push_back(reg);
            }
        }
    }

    // graph_builder.cc:477-514
    void classify_partial_exons() {
        std::map<std::pair<i64, i64>, size_t> mj;
        for (size_t i = 0; i < junctions.size(); i++)
            mj[{junctions[i].lpos, junctions[i].rpos}] = i;
        for (auto& pe : pexons) {
            bool b = false;
            if (pe.lpos == bd.lpos || pe.rpos == bd.rpos) b = true;
            if (pe.ltype == RIGHT_SPLICE || pe.rtype == LEFT_SPLICE) b = true;
            if (pe.ltype == LEFT_SPLICE && pe.rtype == RIGHT_SPLICE) {
                auto it = mj.find({pe.lpos, pe.rpos});
                if (it == mj.end()) b = true;
                else if ((double)junctions[it->second].count < pe.ave) b = true;
            }
            pe.pvalue = b ? 0.0 : 1.0;
        }
    }

    // graph_builder.cc:244-297
    void link_partial_exons() {
        std::map<i64, int> lm, rm;
        for (size_t i = 0; i < pexons.size(); i++) {
            lm[pexons[i].lpos] = (int)i;
            rm[pexons[i].rpos] = (int)i;
        }
        for (auto& jc : junctions) {
            auto li = rm.find(jc.lpos);
            auto ri = lm.find(jc.rpos);
            jc.lexon = li == rm.end() ? -1 : li->second;
            jc.rexon = ri == lm.end() ? -1 : ri->second;
        }
    }

    // graph_builder.cc:299-426
    void build_splice_graph(SpliceGraph& gr) {
        gr.strand = bd.strand;

        gr.add_vertex();
        VertexInfo vi0;
        vi0.lpos = bd.lpos;
        vi0.rpos = bd.lpos;
        vi0.type = 0;
        gr.vwrt[0] = 0.0;
        gr.vinfo[0] = vi0;
        for (size_t i = 0; i < pexons.size(); i++) {
            const PartialExon& r = pexons[i];
            i64 length = r.rpos - r.lpos;
            assert(length >= 1);
            gr.add_vertex();
            double w = std::max(r.ave, cfg.min_guaranteed_edge_weight);
            gr.vwrt[i + 1] = w;
            VertexInfo vi;
            vi.lpos = r.lpos;
            vi.rpos = r.rpos;
            vi.stddev = r.dev;
            vi.maxcov = r.max;
            vi.length = length;
            vi.regional = regional[i];
            vi.type = r.pvalue < 0.5 ? 0 : 1;
            gr.vinfo[i + 1] = vi;
        }
        gr.add_vertex();
        VertexInfo vin;
        vin.lpos = bd.rpos;
        vin.rpos = bd.rpos;
        vin.type = 0;
        gr.vwrt[pexons.size() + 1] = 0.0;
        gr.vinfo[pexons.size() + 1] = vin;

        // junction edges
        for (const auto& b : junctions) {
            if (b.lexon < 0 || b.rexon < 0) continue;
            GEdge* p = gr.add_edge(b.lexon + 1, b.rexon + 1);
            p->info.weight = (double)b.count;
            if (b.strand == '+') p->info.strand = 1;
            if (b.strand == '-') p->info.strand = 2;
            p->wrt = (double)b.count;
        }

        // source/sink edges with neighbor-subtracted weights
        int ss = 0;
        int tt = (int)pexons.size() + 1;
        for (size_t i = 0; i < pexons.size(); i++) {
            const PartialExon& r = pexons[i];
            if (r.ltype == START_BOUNDARY) {
                GEdge* p = gr.add_edge(ss, (int)i + 1);
                double w = r.ave;
                if (i >= 1 && pexons[i - 1].rpos == r.lpos)
                    w -= pexons[i - 1].ave;
                w = std::max(w, cfg.min_guaranteed_edge_weight);
                p->wrt = w;
                p->info.weight = w;
            }
            if (r.rtype == END_BOUNDARY) {
                GEdge* p = gr.add_edge((int)i + 1, tt);
                double w = r.ave;
                if (i + 1 < pexons.size() && pexons[i + 1].lpos == r.rpos)
                    w -= pexons[i + 1].ave;
                w = std::max(w, cfg.min_guaranteed_edge_weight);
                p->wrt = w;
                p->info.weight = w;
            }
        }

        // adjacent-pexon edges weighted by min-ave with degree tie-breaks
        for (size_t i = 0; i + 1 < pexons.size(); i++) {
            const PartialExon& x = pexons[i];
            const PartialExon& y = pexons[i + 1];
            if (x.rpos != y.lpos) continue;
            int xd = gr.out_degree((int)i + 1);
            int yd = gr.in_degree((int)i + 2);
            double wt;
            if (xd < yd) wt = x.ave;
            else if (xd > yd) wt = y.ave;
            else if (x.ave < y.ave) wt = x.ave;
            else wt = y.ave;
            GEdge* p = gr.add_edge((int)i + 1, (int)i + 2);
            wt = std::max(wt, cfg.min_guaranteed_edge_weight);
            p->wrt = wt;
            p->info.weight = wt;
        }
    }
};

// -------------------------------------------------------- graph_reviser.py

// graph_reviser.cc:916-995; returns smap {lpos -> grouped lpos}
inline std::map<i64, i64> group_start_boundaries(SpliceGraph& gr,
                                                 i64 max_dist) {
    std::map<i64, i64> smap;
    std::vector<int> v;
    for (GEdge* e = gr.vout[0].head; e; e = e->onext) v.push_back(e->t);
    std::sort(v.begin(), v.end());
    if (v.size() <= 1) return smap;
    i64 p1 = gr.vinfo[v[0]].lpos;
    i64 p2 = p1;
    int k1 = v[0];
    int k2 = k1;
    GEdge* pa = gr.edge(0, v[0]);
    double wa = pa->wrt;
    GEdge* ea = pa;
    for (size_t i = 1; i < v.size(); i++) {
        i64 p = gr.vinfo[v[i]].lpos;
        GEdge* pb = gr.edge(0, v[i]);
        double wb = pb->wrt;
        bool b = check_continuous_vertices(gr, k2, v[i]);
        if (p - p2 > max_dist) b = false;
        if (!b) {
            p1 = p2 = p;
            k1 = k2 = v[i];
            pa = pb; wa = wb; ea = pb;
        } else {
            smap[p] = p1;
            for (int j = k1; j < v[i]; j++) {
                GEdge* pc = gr.edge(j, j + 1);
                gr.vwrt[j] = gr.vwrt[j] + wb;
                pc->info.count += pb->info.count;
                pc->info.weight += pb->info.weight;
                pc->wrt = pc->wrt + wb;
            }
            wa += wb;
            ea->info.count += pb->info.count;
            ea->info.weight += pb->info.weight;
            pa->wrt = wa;
            gr.remove_edge(pb);
            k2 = v[i];
            p2 = p;
        }
    }
    return smap;
}

// graph_reviser.cc:997-1066; returns tmap {rpos -> grouped rpos}
inline std::map<i64, i64> group_end_boundaries(SpliceGraph& gr, i64 max_dist) {
    std::map<i64, i64> tmap;
    int n = gr.num_vertices() - 1;
    std::vector<int> v;
    for (GEdge* e = gr.vin[n].head; e; e = e->inext) v.push_back(e->s);
    std::sort(v.begin(), v.end(), std::greater<int>());
    if (v.size() <= 1) return tmap;
    i64 p1 = gr.vinfo[v[0]].rpos;
    i64 p2 = p1;
    int k1 = v[0];
    int k2 = k1;
    GEdge* pa = gr.edge(v[0], n);
    double wa = pa->wrt;
    for (size_t i = 1; i < v.size(); i++) {
        i64 p = gr.vinfo[v[i]].rpos;
        GEdge* pb = gr.edge(v[i], n);
        double wb = pb->wrt;
        bool b = check_continuous_vertices(gr, v[i], k2);
        if (p2 - p > max_dist) b = false;
        if (!b) {
            p1 = p2 = p;
            k1 = k2 = v[i];
            pa = pb; wa = wb;
        } else {
            tmap[p] = p1;
            for (int j = v[i]; j < k1; j++) {
                GEdge* pc = gr.edge(j, j + 1);
                double wc = pc->wrt;
                pc->wrt = wc + wb;
                gr.vwrt[j + 1] = wc + wb;
            }
            wa += wb;
            pa->wrt = wa;
            gr.remove_edge(pb);
            k2 = v[i];
            p2 = p;
        }
    }
    return tmap;
}

// graph_reviser.cc:1210-1230
inline void add_distant_in_vertices(const SpliceGraph& gr, int x,
                                    std::set<int>& s) {
    i64 p = gr.vinfo[x].lpos;
    for (GEdge* e = gr.vin[x].head; e; e = e->inext) {
        if (gr.vinfo[e->s].rpos == p) continue;
        s.insert(e->s);
    }
}

inline void add_distant_out_vertices(const SpliceGraph& gr, int x,
                                     std::set<int>& s) {
    i64 p = gr.vinfo[x].rpos;
    for (GEdge* e = gr.vout[x].head; e; e = e->onext) {
        if (gr.vinfo[e->t].lpos == p) continue;
        s.insert(e->t);
    }
}

inline int left_continuous_extend(const SpliceGraph& gr, int x) {
    int z = -1;
    int k = x;
    std::set<int> fb;
    while (true) {
        if (k <= 0 || fb.count(k)) break;
        z = k;
        add_distant_in_vertices(gr, k, fb);
        if (k - 1 <= 0) break;
        if (gr.edge(k - 1, k) == nullptr) break;
        if (gr.vinfo[k - 1].rpos != gr.vinfo[k].lpos) break;
        k--;
    }
    return z;
}

inline int right_continuous_extend(const SpliceGraph& gr, int x) {
    int z = -1;
    int k = x;
    std::set<int> fb;
    int n = gr.num_vertices() - 1;
    while (true) {
        if (k >= n || fb.count(k)) break;
        z = k;
        add_distant_out_vertices(gr, k, fb);
        if (k + 1 >= n) break;
        if (gr.edge(k, k + 1) == nullptr) break;
        if (gr.vinfo[k + 1].lpos != gr.vinfo[k].rpos) break;
        k++;
    }
    return z;
}

// graph_reviser.cc:1155-1181
inline int determine_start_boundary(const SpliceGraph& gr, int a, int b,
                                    double& maxcov, double& in_sum) {
    maxcov = 0.0;
    in_sum = 0.0;
    for (int k = a; k <= b; k++) {
        if (gr.edge(0, k) != nullptr) return -1;
        maxcov = std::max(maxcov, gr.vwrt[k]);
        for (GEdge* e = gr.vin[k].head; e; e = e->inext) {
            int v = e->s;
            if (a <= v && v <= b) continue;
            in_sum += e->wrt;
        }
    }
    return 0;
}

// graph_reviser.cc:1183-1208
inline int determine_end_boundary(const SpliceGraph& gr, int a, int b,
                                  double& maxcov, double& out_sum) {
    maxcov = 0.0;
    out_sum = 0.0;
    int n = gr.num_vertices() - 1;
    for (int k = a; k <= b; k++) {
        if (gr.edge(k, n) != nullptr) return -1;
        maxcov = std::max(maxcov, gr.vwrt[k]);
        for (GEdge* e = gr.vout[k].head; e; e = e->onext) {
            int v = e->t;
            if (a <= v && v <= b) continue;
            out_sum += e->wrt;
        }
    }
    return 0;
}

// graph_reviser.cc:1079-1115
inline bool identify_start_boundary(SpliceGraph& gr, double min_ratio) {
    int besta = -1;
    double bestr = 0.0;
    double bestw = 0.0;
    for (int x = 1; x < gr.num_vertices() - 1; x++) {
        int a = left_continuous_extend(gr, x);
        int b = x;
        if (a < 0 || b < 0 || a > b) continue;
        double maxcov, in_sum;
        if (determine_start_boundary(gr, a, b, maxcov, in_sum) < 0) continue;
        double r = std::log(2 + maxcov) / std::log(2 + in_sum);
        if (r < bestr) continue;
        bestr = r;
        besta = a;
        bestw = maxcov - in_sum;
    }
    if (besta < 0 || bestr < min_ratio) return false;
    GEdge* ee = gr.add_edge(0, besta);
    ee->wrt = bestw;
    ee->info = EdgeInfo();
    return true;
}

// graph_reviser.cc:1117-1153
inline bool identify_end_boundary(SpliceGraph& gr, double min_ratio) {
    int bestb = -1;
    double bestr = 0.0;
    double bestw = 0.0;
    for (int x = 1; x < gr.num_vertices() - 1; x++) {
        int a = x;
        int b = right_continuous_extend(gr, x);
        if (a < 0 || b < 0 || a > b) continue;
        double maxcov, out_sum;
        if (determine_end_boundary(gr, a, b, maxcov, out_sum) < 0) continue;
        double r = std::log(2 + maxcov) / std::log(2 + out_sum);
        if (r < bestr) continue;
        bestr = r;
        bestb = b;
        bestw = maxcov - out_sum;
    }
    if (bestb < 0 || bestr < min_ratio) return false;
    GEdge* ee = gr.add_edge(bestb, gr.num_vertices() - 1);
    ee->wrt = bestw;
    ee->info = EdgeInfo();
    return true;
}

// graph_reviser.cc:1068-1077
inline void identify_boundaries(SpliceGraph& gr, const Cfg& cfg) {
    while (true) {
        bool b1 = identify_start_boundary(gr, cfg.min_boundary_log_ratio);
        bool b2 = identify_end_boundary(gr, cfg.min_boundary_log_ratio);
        if (!b1 && !b2) break;
    }
}

// graph_reviser.cc:1285-1377
inline void remove_false_boundaries(SpliceGraph& gr, const Bundle& bb) {
    std::map<int, i64> fb1, fb2;
    for (const auto& f : bb.frgs) {
        if (f[2] != 0) continue;
        const HitRow& h1 = bb.hits[f[0]];
        const HitRow& h2 = bb.hits[f[1]];
        int u1 = gr.locate_vertex(h1.rpos - 1);
        int u2 = gr.locate_vertex(h2.pos);
        if (u1 < 0 || u2 < 0 || u1 >= u2) continue;
        fb1[u1] += 1;
        fb2[u2] += 1;
    }
    int n = gr.num_vertices() - 1;
    for (const auto& kv : fb1) {
        int x = kv.first;
        i64 cnt = kv.second;
        if (gr.edge(x, n) == nullptr) continue;
        VertexInfo& vi = gr.vinfo[x];
        double w = gr.vwrt[x];
        double s = std::log(1 + (double)cnt + w) - std::log(1 + w);
        vi.unbridge_leaving_count = cnt;
        vi.unbridge_leaving_ratio = s;
    }
    for (const auto& kv : fb2) {
        int x = kv.first;
        i64 cnt = kv.second;
        if (gr.edge(0, x) == nullptr) continue;
        VertexInfo& vi = gr.vinfo[x];
        double w = gr.vwrt[x];
        double s = std::log(1 + (double)cnt + w) - std::log(1 + w);
        vi.unbridge_coming_count = cnt;
        vi.unbridge_coming_ratio = s;
    }
}

}  // namespace core
