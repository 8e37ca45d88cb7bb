// core_solve.h — pereads clustering adapter, the bridging DP, hyper set,
// and the router.
//
// Ports of:
//   build_pereads_clusters <- aletsch_tpu/core/graph_cluster.py
//                             (rnacore/graph_cluster.{h,cc}); delegates to
//                             the existing engine in abam.cpp
//   BridgeSolver           <- aletsch_tpu/bridge/solver.py
//                             (bridge/bridge_solver.{h,cc})
//   HyperSet               <- aletsch_tpu/scallop/hyper_set.py
//                             (scallop/hyper_set.{h,cc})
//   UGraph + Router        <- aletsch_tpu/scallop/{ugraph,router}.py
//                             (graph/undirected_graph.*, scallop/router.{h,cc})

#pragma once

#include "core_build.h"

// the cluster engine lives in abam.cpp (same shared object)
extern "C" {
void* abam_cluster_pereads(
    int32_t n_interior, const int32_t* vstarts, const int32_t* vends,
    const uint8_t* adj_next,
    int32_t n_r, const int32_t* rkeys, const int32_t* rvals,
    int32_t n_l, const int32_t* lkeys, const int32_t* lvals,
    const int32_t* hpos, const int32_t* hrpos,
    const int32_t* chain_off, const int32_t* chain_len,
    const int32_t* chain_pool,
    int32_t n_cand, const int32_t* cand_frag, const int32_t* cand_h1,
    const int32_t* cand_h2, int32_t max_gap);
void abam_cluster_sizes(void* o, int64_t* out3);
void abam_cluster_fill(void* o, int32_t* meta, int32_t* moff,
                       int32_t* members, uint8_t* aligned);
void abam_cluster_free(void* o);
}

namespace core {

// ------------------------------------------------------- pereads clusters

struct PereadsCluster {
    std::vector<i64> chain1, chain2;
    i64 bounds[4] = {0, 0, 0, 0};
    i64 extend[4] = {0, 0, 0, 0};
    std::vector<int> frlist;
    i64 count = 0;
};

// graph_cluster.py build_pereads_clusters via the native engine
// (_build_clusters_native export + abam_cluster_pereads)
// Graph-derived i32 arrays for abam_cluster_pereads, reusable across the
// bundles of one joint-bridge pass: the conversion is per GRAPH, and
// joint bridging runs build_pereads_clusters once per bundle over the
// SAME combined graph (assembler.cc:977-1018).
struct PereadsGraphArrays {
    int ni = 0;
    std::vector<i32> vstarts, vends, rkeys, rvals, lkeys, lvals;
    std::vector<uint8_t> adj;

    void prepare(const SpliceGraph& gr) {
        int n = gr.num_vertices();
        ni = n >= 3 ? n - 2 : 0;
        vstarts.resize(ni);
        vends.resize(ni);
        for (int k = 1; k < n - 1; k++) {
            vstarts[k - 1] = (i32)gr.vinfo[k].lpos;
            vends[k - 1] = (i32)gr.vinfo[k].rpos;
        }
        adj.assign(std::max(ni - 1, 1), 0);
        for (int k = 1; k < n - 2; k++)
            if (gr.edge(k, k + 1) != nullptr) adj[k - 1] = 1;
        rkeys.clear(); rvals.clear(); lkeys.clear(); lvals.clear();
        for (size_t z = 0; z < gr.rindex.keys.size(); z++) {
            rkeys.push_back((i32)gr.rindex.keys[z]);
            rvals.push_back((i32)gr.rindex.vals[z]);
        }
        for (size_t z = 0; z < gr.lindex.keys.size(); z++) {
            lkeys.push_back((i32)gr.lindex.keys[z]);
            lvals.push_back((i32)gr.lindex.vals[z]);
        }
    }
};

inline void build_pereads_clusters(const SpliceGraph& gr, Bundle& bd,
                                   i64 max_gap,
                                   std::vector<PereadsCluster>& vc,
                                   const PereadsGraphArrays* gp = nullptr) {
    vc.clear();
    // candidates (fragments still to bridge); assume unbridgeable first
    std::vector<i32> cand_frag, cand_h1, cand_h2;
    for (size_t i = 0; i < bd.frgs.size(); i++) {
        auto& f = bd.frgs[i];
        if (f[2] >= 1 || f[2] <= -1) continue;
        f[2] = -1;
        i64 h1 = f[0], h2 = f[1];
        const HitRow& hit1 = bd.hits[h1];
        const HitRow& hit2 = bd.hits[h2];
        if (hit1.pos > hit2.pos || hit1.rpos > hit2.rpos) continue;
        cand_frag.push_back((i32)i);
        cand_h1.push_back((i32)h1);
        cand_h2.push_back((i32)h2);
    }
    int n = gr.num_vertices();
    if (cand_frag.empty() || n < 3) return;
    PereadsGraphArrays local;
    if (gp == nullptr) {
        local.prepare(gr);
        gp = &local;
    }
    // hit coordinates and chains straight from the scanner rows
    std::vector<i32> hpos(bd.nh), hrpos(bd.nh), choff(bd.nh), chlen(bd.nh);
    for (i64 j = 0; j < bd.nh; j++) {
        const i32* row = bd.fixed + 25 * j;
        hpos[j] = row[1];
        hrpos[j] = row[2];
        choff[j] = row[17] + 2 * row[18];
        chlen[j] = row[19];
    }
    void* h = abam_cluster_pereads(
        gp->ni, gp->vstarts.data(), gp->vends.data(), gp->adj.data(),
        (i32)gp->rkeys.size(), gp->rkeys.data(), gp->rvals.data(),
        (i32)gp->lkeys.size(), gp->lkeys.data(), gp->lvals.data(),
        hpos.data(), hrpos.data(), choff.data(), chlen.data(),
        bd.coords, (i32)cand_frag.size(), cand_frag.data(), cand_h1.data(),
        cand_h2.data(), (i32)max_gap);
    int64_t sizes[3];
    abam_cluster_sizes(h, sizes);
    i64 nc = sizes[0], nm = sizes[1], na = sizes[2];
    std::vector<i32> meta(std::max<i64>(nc * 10, 1));
    std::vector<i32> moff(std::max<i64>(nc, 1));
    std::vector<i32> members(std::max<i64>(nm, 1));
    std::vector<uint8_t> aligned(std::max<i64>(na, 1));
    abam_cluster_fill(h, meta.data(), moff.data(), members.data(),
                      aligned.data());
    abam_cluster_free(h);
    for (i64 j = 0; j < na; j++)
        if (aligned[j]) bd.frgs[cand_frag[j]][2] = 0;   // to be bridged
    vc.resize(nc);
    for (i64 c = 0; c < nc; c++) {
        i64 rep = meta[c * 10 + 0];
        PereadsCluster& pc = vc[c];
        pc.count = meta[c * 10 + 1];
        const auto& f0 = bd.frgs[rep];
        bd.hcst.get_chain(f0[0], pc.chain1);
        bd.hcst.get_chain(f0[1], pc.chain2);
        for (int d = 0; d < 4; d++) {
            pc.bounds[d] = meta[c * 10 + 2 + d];
            pc.extend[d] = meta[c * 10 + 6 + d];
        }
        i64 a = moff[c];
        i64 b = (c + 1 < nc) ? moff[c + 1] : nm;
        pc.frlist.assign(members.begin() + a, members.begin() + b);
    }
}

// ------------------------------------------------------------ BridgeSolver
// bridge/solver.py (bridge/bridge_solver.{h,cc})

struct BridgePath {
    int type = -1;
    i64 score = 0;
    std::vector<i64> stack;
    std::vector<int> v;
    std::vector<i64> chain;
    std::vector<i64> whole;
    int strand = 0;
    i64 choices = 0;
};

struct BridgeSolver {
    SpliceGraph& gr;
    std::vector<PereadsCluster>& vc;
    const Cfg& cfg;
    i64 length_low, length_high;
    std::vector<BridgePath> opt;

    std::vector<GEdge*> adjedges;
    std::set<std::pair<i64, i64>> pseudos;
    struct Pier {
        int bs, bt;
        std::vector<BridgePath> bridges;
    };
    std::vector<Pier> piers;
    std::vector<std::pair<int, int>> vpairs;

    // Flat-arena DP table: all entries live in one arena (stacks is
    // [n_entries, S] row-major), per-vertex entry id ranges in vbeg/vend.
    // Replaces the vector<vector<Entry>> form — per-entry heap stacks and
    // whole-Entry stable_sort moves were ~25% of the production DP
    // (gprof, native/replay_batch.cpp); order and values are identical.
    struct DPTable {
        int S = 0;
        std::vector<i64> stacks;    // entry id e -> stacks[e*S .. e*S+S)
        std::vector<i64> lengths;
        std::vector<int> tr1, tr2;  // trace: parent vertex / entry SLOT
        std::vector<int> vbeg, vend;
        int nsol(int k) const { return vend[k] - vbeg[k]; }
        const i64* stack_at(int k, int j) const {
            return stacks.data() + (size_t)(vbeg[k] + j) * S;
        }
        i64 length_at(int k, int j) const { return lengths[vbeg[k] + j]; }
    };

    // One DP program of nominate(): a (strand, same-source pier run) pair
    // over the window [k1, k2] (bridge_solver.cc:180-257).  In deferred
    // mode these are solved one by one — on device (ops/bridge_topk.py)
    // or by the host DP — between construction and finalize().
    struct DPInst {
        int strand, b1, b2, k1, k2;
    };
    std::vector<DPInst> insts;
    size_t inst_i = 0;          // next instance to solve

    bool owns_adj = true;   // false: adjacent edges hoisted by the caller
                            // (shared across the joint phase's solvers --
                            // serial solvers see the identical graph, see
                            // GroupRun::joint_setup)

    BridgeSolver(SpliceGraph& g, std::vector<PereadsCluster>& v,
                 const Cfg& c, i64 low, i64 high, bool defer = false,
                 const std::vector<GEdge*>* shared_adj = nullptr)
        : gr(g), vc(v), cfg(c), length_low(low), length_high(high) {
        if (shared_adj != nullptr) {
            adjedges = *shared_adj;
            owns_adj = false;
        } else {
            add_adjacent_edges();
        }
        build_pseudo_introns();
        build_bridging_vertices();
        build_piers();
        if (defer) {
            prepare_instances();
            return;
        }
        nominate();
        vote_all();
        if (owns_adj) remove_adjacent_edges();
    }

    // bridge_solver.cc:71-95
    void add_adjacent_edges() {
        for (int i = 1; i < gr.num_vertices() - 2; i++) {
            if (gr.edge(i, i + 1) != nullptr) continue;
            GEdge* e = gr.add_edge(i, i + 1);
            e->wrt = 0.5;
            e->info.weight = 0.5;
            adjedges.push_back(e);
        }
    }
    void remove_adjacent_edges() {
        for (GEdge* e : adjedges) gr.remove_edge(e);
    }
    // bridge_solver.cc:97-108
    void build_pseudo_introns() {
        for (GEdge* e : adjedges) {
            i64 p1 = gr.vinfo[e->s].rpos;
            i64 p2 = gr.vinfo[e->t].lpos;
            if (p1 >= p2) continue;
            pseudos.insert({p1, p2});
        }
    }
    // bridge_solver.cc:110-122
    std::vector<i64> filter_pseudo_introns(const std::vector<i64>& chain) {
        std::vector<i64> v;
        for (size_t k = 0; k < chain.size() / 2; k++) {
            std::pair<i64, i64> p{chain[2 * k], chain[2 * k + 1]};
            if (pseudos.count(p)) continue;
            v.push_back(p.first);
            v.push_back(p.second);
        }
        return v;
    }

    // bridge_solver.cc:124-135
    bool check_left_relaxing(const PereadsCluster& pc, int v) {
        int n = gr.num_vertices() - 1;
        if (v <= 0 || v >= n) return false;
        i64 p = gr.vinfo[v].lpos;
        if (v <= 1) return false;
        if (!check_continuous_vertices(gr, v - 1, v)) return false;
        if (pc.bounds[1] - p > cfg.bridge_end_relaxing) return false;
        if (!pc.chain1.empty() && pc.chain1.back() >= p) return false;
        return true;
    }
    // bridge_solver.cc:137-148
    bool check_right_relaxing(const PereadsCluster& pc, int v) {
        int n = gr.num_vertices() - 1;
        if (v <= 0 || v >= n) return false;
        i64 p = gr.vinfo[v].rpos;
        if (v >= n - 1) return false;
        if (!check_continuous_vertices(gr, v, v + 1)) return false;
        if (p - pc.bounds[2] > cfg.bridge_end_relaxing) return false;
        if (!pc.chain2.empty() && pc.chain2.front() <= p) return false;
        return true;
    }
    // bridge_solver.cc:53-69
    void build_bridging_vertices() {
        vpairs.clear();
        for (const auto& pc : vc) {
            int v1 = gr.locate_vertex(pc.bounds[1] - 1);
            int v2 = gr.locate_vertex(pc.bounds[2]);
            if (check_left_relaxing(pc, v1)) v1 -= 1;
            if (check_right_relaxing(pc, v2)) v2 += 1;
            vpairs.push_back({v1, v2});
        }
    }
    // bridge_solver.cc:150-167
    void build_piers() {
        piers.clear();
        std::set<std::pair<int, int>> ss;
        for (const auto& p : vpairs) {
            if (p.first < 0 || p.second < 0 || p.first >= p.second) continue;
            if (ss.count(p)) continue;
            ss.insert(p);
            piers.push_back(Pier{p.first, p.second, {}});
        }
    }

    // bridge_solver.cc:532-546: insert s into ascending stack, keep
    // smallest (allocation-free form of the reference's update_stack —
    // identical element-for-element, including the trailing-zero fill)
    static void update_stack_into(const i64* v, int n, i64 s, i64* out) {
        for (int t = 0; t < n; t++) out[t] = 0;
        int i = 0, j = 0;
        while (i < n && j < n) {
            if (i == j && v[i] > s) {
                out[j] = s;
                j++;
                if (j >= n) break;
            }
            out[j] = v[i];
            i++;
            j++;
        }
    }

    // bridge_solver.cc:484-530 — flat-arena form: candidates accumulate in
    // reusable scratch arrays and an index permutation is stable-sorted
    // (entry_compare key: stack descending lexicographically, then shorter
    // length; ties keep insertion order — exactly what stable_sort over
    // whole Entry structs produced, at a fraction of the moves/allocs)
    DPTable dynamic_programming(int k1, int k2, int strand) {
        int n = gr.num_vertices();
        const int S = (int)cfg.bridge_dp_stack_size;
        DPTable t;
        t.S = S;
        t.vbeg.assign(n, 0);
        t.vend.assign(n, 0);
        const VertexInfo& vi = gr.vinfo[k1];
        t.stacks.assign(S, 999999);
        t.lengths.push_back(vi.rpos - vi.lpos);
        t.tr1.push_back(-1);
        t.tr2.push_back(-1);
        t.vbeg[k1] = 0;
        t.vend[k1] = 1;
        std::vector<i64> cstack, clen;
        std::vector<int> ctr1, ctr2, idx;
        for (int k = k1 + 1; k <= k2; k++) {
            cstack.clear(); clen.clear(); ctr1.clear(); ctr2.clear();
            const VertexInfo& vk = gr.vinfo[k];
            i64 length = vk.rpos - vk.lpos;
            for (GEdge* e = gr.vin[k].head; e; e = e->inext) {
                int s = e->info.strand;
                if (s != 0 && s != strand) continue;
                int j = e->s;
                if (j < k1 || t.nsol(j) == 0) continue;
                i64 w = (i64)e->wrt;    // truncation toward zero, like int()
                int ns = t.nsol(j);
                for (int i = 0; i < ns; i++) {
                    size_t base = cstack.size();
                    cstack.resize(base + S);
                    update_stack_into(t.stack_at(j, i), S, w,
                                      cstack.data() + base);
                    clen.push_back(t.length_at(j, i) + length);
                    ctr1.push_back(j);
                    ctr2.push_back(i);
                }
            }
            int nc = (int)clen.size();
            idx.resize(nc);
            for (int i = 0; i < nc; i++) idx[i] = i;
            const i64* cs = cstack.data();
            const i64* cl = clen.data();
            std::stable_sort(idx.begin(), idx.end(),
                [cs, cl, S](int a, int b) {
                    const i64* pa = cs + (size_t)a * S;
                    const i64* pb = cs + (size_t)b * S;
                    for (int i = 0; i < S; i++)
                        if (pa[i] != pb[i]) return pa[i] > pb[i];
                    return cl[a] < cl[b];
                });
            int keep = nc;
            if ((i64)keep > cfg.bridge_dp_solution_size)
                keep = (int)cfg.bridge_dp_solution_size;
            t.vbeg[k] = (int)t.lengths.size();
            for (int i = 0; i < keep; i++) {
                int c = idx[i];
                const i64* src = cs + (size_t)c * S;
                t.stacks.insert(t.stacks.end(), src, src + S);
                t.lengths.push_back(cl[c]);
                t.tr1.push_back(ctr1[c]);
                t.tr2.push_back(ctr2[c]);
            }
            t.vend[k] = (int)t.lengths.size();
        }
        return t;
    }

    // bridge_solver.cc:548-568
    std::vector<std::vector<int>> trace_back(int k, const DPTable& t) {
        std::vector<std::vector<int>> vv;
        int ns = t.nsol(k);
        for (int i = 0; i < ns; i++) {
            std::vector<int> v;
            int p = k, q = i;
            while (true) {
                v.push_back(p);
                int e = t.vbeg[p] + q;
                int np = t.tr1[e];
                q = t.tr2[e];
                p = np;
                if (p < 0) break;
            }
            std::reverse(v.begin(), v.end());
            vv.push_back(std::move(v));
        }
        return vv;
    }

    // bridge_solver.cc:259-274
    void refine_pier(Pier& pr) {
        if (pr.bridges.empty()) return;
        std::stable_sort(pr.bridges.begin(), pr.bridges.end(),
            [](const BridgePath& a, const BridgePath& b) {
                if (a.v != b.v)
                    return std::lexicographical_compare(
                        a.v.begin(), a.v.end(), b.v.begin(), b.v.end());
                return a.v.size() < b.v.size();
            });
        std::vector<BridgePath> v;
        v.push_back(pr.bridges[0]);
        for (size_t i = 1; i < pr.bridges.size(); i++) {
            if (pr.bridges[i].v == v.back().v) continue;
            v.push_back(pr.bridges[i]);
        }
        // key: ([-x for x in stack], -len(stack)) ascending
        std::stable_sort(v.begin(), v.end(),
            [](const BridgePath& a, const BridgePath& b) {
                size_t na = a.stack.size(), nb = b.stack.size();
                for (size_t i = 0; i < na && i < nb; i++) {
                    if (a.stack[i] != b.stack[i])
                        return a.stack[i] > b.stack[i];
                }
                if (na != nb) return na < nb;   // tuple prefix rule
                return false;                   // equal keys
            });
        pr.bridges.swap(v);
    }

    // bridge_solver.cc:205-222
    std::vector<std::pair<int, int>> build_bounds() {
        std::vector<std::pair<int, int>> bounds;
        int b1 = 0;
        for (size_t i = 1; i < piers.size(); i++) {
            if (piers[i].bs != piers[i - 1].bs) {
                bounds.push_back({b1, (int)i - 1});
                b1 = (int)i;
            }
        }
        bounds.push_back({b1, (int)piers.size() - 1});
        return bounds;
    }

    // consume one DP table for the pier run [b1, b2]
    // (the inner loop of bridge_solver.cc:227-252)
    void consume_host_table(int b1, int b2, const DPTable& table) {
        std::vector<i64> chain;
        for (int b = b1; b <= b2; b++) {
            int bt = piers[b].bt;
            auto paths = trace_back(bt, table);
            for (size_t j = 0; j < paths.size(); j++) {
                BridgePath p;
                const i64* st = table.stack_at(bt, (int)j);
                p.score = st[0];
                p.stack.assign(st, st + table.S);
                p.v = paths[j];
                build_intron_coordinates_from_path(gr, p.v, chain);
                p.chain = filter_pseudo_introns(chain);
                piers[b].bridges.push_back(std::move(p));
            }
        }
    }

    // bridge_solver.cc:180-257
    void nominate() {
        prepare_instances();
        for (const DPInst& in : insts) {
            auto table = dynamic_programming(in.k1, in.k2, in.strand);
            consume_host_table(in.b1, in.b2, table);
        }
        for (auto& pr : piers) refine_pier(pr);
    }

    // ---- deferred mode (device bridging, ops/bridge_topk.py): the pier
    // sort + bounds + strand expansion of nominate(), instances solved
    // between construction and finalize()

    void prepare_instances() {
        insts.clear();
        inst_i = 0;
        if (piers.empty()) return;
        std::stable_sort(piers.begin(), piers.end(),
            [](const Pier& a, const Pier& b) {
                if (a.bs != b.bs) return a.bs < b.bs;
                return a.bt < b.bt;
            });
        std::vector<std::pair<int, int>> bounds = build_bounds();
        std::vector<int> strands;
        if (gr.strand == '.') strands = {1, 2};
        else if (gr.strand == '+') strands = {1};
        else strands = {2};
        for (int st : strands)
            for (auto& bb : bounds)
                insts.push_back(DPInst{st, bb.first, bb.second,
                                       piers[bb.second].bs,
                                       piers[bb.second].bt});
    }

    // host-solve the current instance (fallback for device-ineligible ones)
    void solve_inst_host() {
        const DPInst& in = insts[inst_i];
        auto table = dynamic_programming(in.k1, in.k2, in.strand);
        consume_host_table(in.b1, in.b2, table);
        inst_i++;
    }

    // Export the current instance as one padded batch row for the device
    // kernel (ops/bridge_topk.py layout: P/Wt [V, E] i32 predecessor /
    // clamped weight per in-edge slot in host in-edge order, Lv [V] vertex
    // lengths, tgt [T] topo-local targets; -1 = absent).  Coordinates are
    // topo-local to the window (k1 -> 0).  Returns the window size on
    // success, 0 when the instance must be solved on host (window or
    // in-degree or target-run beyond the padded shape, or a cfg K/S the
    // kernel was not built for).
    int export_inst(i32* P, i32* Wt, i32* Lv, i32* tgt,
                    int V, int E, int T, int K, int S) {
        return export_inst_at(inst_i, P, Wt, Lv, tgt, V, E, T, K, S);
    }
    int export_inst_at(size_t idx, i32* P, i32* Wt, i32* Lv, i32* tgt,
                       int V, int E, int T, int K, int S) {
        const DPInst& in = insts[idx];
        if (cfg.bridge_dp_solution_size != K) return 0;
        if (cfg.bridge_dp_stack_size != S) return 0;
        int n = in.k2 - in.k1 + 1;
        if (n > V) return 0;
        if (in.b2 - in.b1 + 1 > T) return 0;
        for (int r = 0; r < V * E; r++) {
            P[r] = -1;
            Wt[r] = 0;
        }
        for (int r = 0; r < V; r++) Lv[r] = 0;
        for (int t = 0; t < T; t++) tgt[t] = -1;
        for (int k = in.k1; k <= in.k2; k++) {
            int lr = k - in.k1;
            Lv[lr] = (i32)(gr.vinfo[k].rpos - gr.vinfo[k].lpos);
            if (lr == 0) continue;      // source row: no in-edges in the DP
            int c = 0;
            for (GEdge* e = gr.vin[k].head; e; e = e->inext) {
                int s = e->info.strand;
                if (s != 0 && s != in.strand) continue;
                int j = e->s;
                if (j < in.k1) continue;
                i64 w = (i64)e->wrt;    // truncation toward zero, like int()
                if (w < 0) return 0;    // kernel clamp assumes w >= 0
                if (w > 999999) w = 999999;
                if (c >= E) return 0;
                P[lr * E + c] = j - in.k1;
                Wt[lr * E + c] = (i32)w;
                c++;
            }
        }
        for (int b = in.b1; b <= in.b2; b++)
            tgt[b - in.b1] = piers[b].bt - in.k1;
        return n;
    }

    // Consume the device results for the current instance: target stacks
    // ostk [T, K, S] (entry j valid iff ostk[t][j][0] >= 0; valid entries
    // form a prefix of the K slots) plus the full parent / entry-index
    // tables par / pix [V, K] for the backtrace (bridge_solver.cc:548-568).
    void consume_device(const i32* ostk, const i32* par, const i32* pix,
                        int V, int T, int K, int S) {
        const DPInst& in = insts[inst_i];
        (void)V;
        (void)T;
        std::vector<i64> chain;
        for (int b = in.b1; b <= in.b2; b++) {
            int t = b - in.b1;
            for (int j = 0; j < K; j++) {
                const i32* st = ostk + ((size_t)t * K + j) * S;
                if (st[0] < 0) break;
                BridgePath p;
                p.score = st[0];
                p.stack.assign(st, st + S);
                int pv = piers[b].bt - in.k1, q = j;
                std::vector<int> v;
                while (true) {
                    v.push_back(pv + in.k1);
                    int np = par[(size_t)pv * K + q];
                    int nq = pix[(size_t)pv * K + q];
                    if (np < 0) break;
                    pv = np;
                    q = nq;
                }
                std::reverse(v.begin(), v.end());
                p.v = std::move(v);
                build_intron_coordinates_from_path(gr, p.v, chain);
                p.chain = filter_pseudo_introns(chain);
                piers[b].bridges.push_back(std::move(p));
            }
        }
        inst_i++;
    }

    bool insts_done() const { return inst_i >= insts.size(); }

    // deferred-mode epilogue: the tail of the non-deferred constructor
    void finalize() {
        for (auto& pr : piers) refine_pier(pr);
        vote_all();
        if (owns_adj) remove_adjacent_edges();
    }

    size_t pending() const { return insts.size() - inst_i; }

    // bridge_solver.cc:276-285
    void vote_all() {
        std::map<std::pair<int, int>, int> pindex;
        for (size_t i = 0; i < piers.size(); i++)
            pindex[{piers[i].bs, piers[i].bt}] = (int)i;
        opt.clear();
        for (size_t i = 0; i < vc.size(); i++)
            opt.push_back(vote((int)i, pindex));
    }

    // bridge_solver.cc:287-385
    BridgePath vote(int r, const std::map<std::pair<int, int>, int>& pindex) {
        BridgePath bbp;
        bbp.type = -1;
        int ss = vpairs[r].first, tt = vpairs[r].second;
        if (ss < 0 || tt < 0) return bbp;
        const PereadsCluster& pc = vc[r];

        std::vector<std::vector<i64>> chains, wholes;
        std::vector<i64> scores;
        std::vector<int> strands;
        int typ = 0;
        if (ss >= tt) {
            std::vector<i64> w;
            if (!merge_intron_chains(pc.chain1, pc.chain2, w)) return bbp;
            if (!check_increasing(w)) return bbp;
            int s = check_strand_from_intron_coordinates(gr, w);
            if (s < 0) return bbp;
            typ = 1;
            chains.push_back({});
            wholes.push_back(w);
            scores.push_back(10);
            strands.push_back(s);
        } else {
            auto it = pindex.find({ss, tt});
            if (it != pindex.end()) {
                typ = 2;
                for (const BridgePath& pb : piers[it->second].bridges) {
                    std::vector<i64> w(pc.chain1);
                    w.insert(w.end(), pb.chain.begin(), pb.chain.end());
                    w.insert(w.end(), pc.chain2.begin(), pc.chain2.end());
                    if (!check_increasing(w)) continue;
                    int s = check_strand_from_intron_coordinates(gr, w);
                    if (s < 0) continue;
                    wholes.push_back(std::move(w));
                    chains.push_back(pb.chain);
                    scores.push_back(pb.score);
                    strands.push_back(s);
                }
            }
        }

        if (chains.empty()) return bbp;

        int be = -1;
        i64 choices = 0;
        for (size_t e = 0; e < chains.size(); e++) {
            if (!wholes[e].empty() && wholes[e].front() <= pc.bounds[0])
                continue;
            if (!wholes[e].empty() && wholes[e].back() >= pc.bounds[3])
                continue;
            i64 intron = get_total_length_of_introns(wholes[e]);
            i64 length = pc.bounds[3] - pc.bounds[0] - intron;
            if (length < length_low || length > length_high) continue;
            if (strands[e] < 0) continue;
            if (be < 0) be = (int)e;
            choices++;
        }

        if (be < 0) return bbp;
        bbp.type = typ;
        bbp.score = scores[be];
        bbp.chain = chains[be];
        bbp.whole = wholes[be];
        bbp.strand = strands[be];
        bbp.choices = choices;
        return bbp;
    }
};

// ---------------------------------------------------------------- HyperSet
// scallop/hyper_set.py (scallop/hyper_set.{h,cc}); edge lists may contain
// -1 separators; e2s sets iterate sorted (canonicalized in Python too).

struct HyperSet {
    std::map<std::vector<int>, i64> nodes;       // vertex list -> count
    std::vector<std::vector<int>> edges;         // hyper-edge edge-index lists
    std::vector<i64> ecnts;
    std::unordered_map<int, std::set<int>> e2s;  // edge idx -> hyper ids

    // hyper_set.py __init__(gr, ps)
    void init_from_phase_set(const SpliceGraph& gr, const PhaseSet& ps) {
        std::vector<int> vv;
        for (const auto& kv : ps.pmap) {
            if (!build_path_from_exon_coordinates(gr, kv.first, vv)) continue;
            add_node_list(vv, kv.second);
        }
    }
    void add_node_list(const std::vector<int>& s, i64 c) {
        std::vector<int> v(s);
        std::sort(v.begin(), v.end());
        nodes[v] += c;
    }
    // hyper_set.cc:356-371
    void filter_nodes(const SpliceGraph& gr) {
        std::map<std::vector<int>, i64> mv;
        for (const auto& kv : nodes) {
            if (kv.first.size() <= 1) continue;
            if (!check_valid_path(gr, kv.first)) continue;
            mv[kv.first] = kv.second;
        }
        nodes.swap(mv);
    }
    // hyper_set.cc:323-354; nodes iterated in sorted order (std::map)
    void build(const SpliceGraph& gr) {
        edges.clear();
        ecnts.clear();
        for (const auto& kv : nodes) {
            const std::vector<int>& vv = kv.first;
            i64 c = kv.second;
            if (c <= 1) continue;
            if (vv.size() <= 1) continue;
            std::vector<int> ve;
            bool ok = true;
            for (size_t k = 0; k + 1 < vv.size(); k++) {
                GEdge* e = gr.edge(vv[k], vv[k + 1]);
                if (e == nullptr) {
                    ok = false;
                    ve.push_back(-1);
                } else {
                    ve.push_back(e->si);
                }
            }
            if (ok && ve.size() >= 2) {
                edges.push_back(std::move(ve));
                ecnts.push_back(c);
            }
        }
        build_index();
    }
    // hyper_set.cc:436-459
    void build_index() {
        e2s.clear();
        for (size_t i = 0; i < edges.size(); i++)
            for (int e : edges[i]) {
                if (e == -1) continue;
                e2s[e].insert((int)i);
            }
    }

    // hyper_set.cc:489-507
    std::set<int> get_intersection(const std::vector<int>& v) const {
        std::set<int> ss;
        if (v.empty()) return ss;
        auto it = e2s.find(v[0]);
        if (it == e2s.end()) return ss;
        ss = it->second;
        for (size_t i = 1; i < v.size(); i++) {
            auto jt = e2s.find(v[i]);
            if (jt == e2s.end()) return std::set<int>();
            std::set<int> nw;
            std::set_intersection(ss.begin(), ss.end(), jt->second.begin(),
                                  jt->second.end(),
                                  std::inserter(nw, nw.begin()));
            ss.swap(nw);
        }
        return ss;
    }

    // hyper_set.cc:509-529; sorted hyper-edge visit order (canonical)
    // accumulates into an insertion-ordered (nxt -> count) map
    void get_successors(int e, std::vector<std::pair<int, i64>>& s) const {
        s.clear();
        auto it = e2s.find(e);
        if (it == e2s.end()) return;
        for (int k : it->second) {     // std::set iterates sorted
            const std::vector<int>& v = edges[k];
            i64 c = ecnts[k];
            for (size_t i = 0; i + 1 < v.size(); i++) {
                if (v[i] != e) continue;
                int nxt = v[i + 1];
                if (nxt == -1) continue;
                bool found = false;
                for (auto& kv : s)
                    if (kv.first == nxt) { kv.second += c; found = true; break; }
                if (!found) s.push_back({nxt, c});
            }
        }
    }

    // hyper_set.cc:626-675
    void replace_list(const std::vector<int>& v, int e) {
        if (v.empty()) return;
        std::set<int> s = get_intersection(v);
        std::vector<int> fb;
        for (int k : s) {              // sorted
            std::vector<int>& vv = edges[k];
            std::vector<i64> bv = consecutive_subset(vv, v);
            if (bv.empty()) continue;
            std::sort(bv.begin(), bv.end(), std::greater<i64>());
            for (i64 b : bv) {
                vv[b] = e;
                vv.erase(vv.begin() + b + 1, vv.begin() + b + (i64)v.size());
            }
            fb.push_back(k);
            e2s[e].insert(k);
        }
        if (v.size() != 1) return;
        for (int u : v) {
            auto it = e2s.find(u);
            if (it == e2s.end()) continue;
            for (int k : fb) it->second.erase(k);
            if (it->second.empty()) e2s.erase(it);
        }
    }
    void replace(int x, int e) { replace_list({x}, e); }
    void replace_pair(int x, int y, int e) { replace_list({x, y}, e); }

    // hyper_set.cc:787-818
    void remove(int e) {
        auto it = e2s.find(e);
        if (it == e2s.end()) return;
        for (int k : it->second) {
            std::vector<int>& vv = edges[k];
            for (auto& x : vv)
                if (x == e) x = -1;
        }
        e2s.erase(it);
    }
    void remove_pair(int x, int y) { insert_between(x, y, -1); }

    // hyper_set.cc:865-902
    void insert_between(int x, int y, int e) {
        auto it = e2s.find(x);
        if (it == e2s.end()) return;
        std::vector<int> ks(it->second.begin(), it->second.end());   // sorted
        for (int k : ks) {
            std::vector<int>& vv = edges[k];
            size_t i = 0;
            while (i + 1 < vv.size()) {
                if (vv[i] == x && vv[i + 1] == y) {
                    vv.insert(vv.begin() + i + 1, e);
                    if (e != -1) e2s[e].insert(k);
                    i++;   // skip over the inserted element
                }
                i++;
            }
        }
    }

    // hyper_set.cc:949-965
    bool left_extend(int e) const {
        auto it = e2s.find(e);
        if (it == e2s.end()) return false;
        for (int k : it->second) {
            const std::vector<int>& vv = edges[k];
            for (size_t i = 1; i < vv.size(); i++)
                if (vv[i] == e && vv[i - 1] != -1) return true;
        }
        return false;
    }
    // hyper_set.cc:967-983
    bool right_extend(int e) const {
        auto it = e2s.find(e);
        if (it == e2s.end()) return false;
        for (int k : it->second) {
            const std::vector<int>& vv = edges[k];
            for (size_t i = 0; i + 1 < vv.size(); i++)
                if (vv[i] == e && vv[i + 1] != -1) return true;
        }
        return false;
    }

    // hyper_set.cc:1003-1042
    bool left_dominate(int e) const {
        auto it = e2s.find(e);
        if (it == e2s.end()) return true;
        std::set<std::pair<int, int>> x1, x2;
        for (int k : it->second) {
            const std::vector<int>& vv = edges[k];
            for (size_t i = 0; i + 1 < vv.size(); i++) {
                if (vv[i] != e || vv[i + 1] == -1) continue;
                if (i == 0 || vv[i - 1] == -1) {
                    if (i + 2 < vv.size()) x1.insert({vv[i + 1], vv[i + 2]});
                    else x1.insert({vv[i + 1], -1});
                } else {
                    x2.insert({vv[i + 1], -1});
                    if (i + 2 < vv.size()) x2.insert({vv[i + 1], vv[i + 2]});
                }
            }
        }
        return std::includes(x2.begin(), x2.end(), x1.begin(), x1.end());
    }
    // hyper_set.cc:1044-1082
    bool right_dominate(int e) const {
        auto it = e2s.find(e);
        if (it == e2s.end()) return true;
        std::set<std::pair<int, int>> x1, x2;
        for (int k : it->second) {
            const std::vector<int>& vv = edges[k];
            for (size_t i = 1; i < vv.size(); i++) {
                if (vv[i] != e || vv[i - 1] == -1) continue;
                if (i == vv.size() - 1 || vv[i + 1] == -1) {
                    if ((i64)i - 2 >= 0) x1.insert({vv[i - 1], vv[i - 2]});
                    else x1.insert({vv[i - 1], -1});
                } else {
                    x2.insert({vv[i - 1], -1});
                    if ((i64)i - 2 >= 0) x2.insert({vv[i - 1], vv[i - 2]});
                }
            }
        }
        return std::includes(x2.begin(), x2.end(), x1.begin(), x1.end());
    }
};

// -------------------------------------------------------------- UGraph
// scallop/ugraph.py: insertion-ordered small undirected graph

struct UGraph {
    struct UEdge {
        int a, b;
        int eid;
        bool alive = true;
        int neighbor(int x) const { return x == a ? b : a; }
    };
    std::vector<UEdge> pool;                    // by eid
    std::vector<std::vector<int>> adj;          // per-vertex edge ids
    int nlive = 0;

    int add_vertex() {
        adj.push_back({});
        return (int)adj.size() - 1;
    }
    int num_vertices() const { return (int)adj.size(); }
    int num_edges() const { return nlive; }
    int add_edge(int a, int b) {
        int eid = (int)pool.size();
        pool.push_back(UEdge{a, b, eid, true});
        adj[a].push_back(eid);
        if (b != a) adj[b].push_back(eid);   // dict semantics: one entry
        nlive++;
        return eid;
    }
    int degree(int v) const { return (int)adj[v].size(); }
    void clear_vertex(int v) {
        std::vector<int> es(adj[v]);
        for (int eid : es) {
            UEdge& e = pool[eid];
            auto rm = [&](int x) {
                auto& a = adj[x];
                a.erase(std::find(a.begin(), a.end(), eid));
            };
            rm(e.a);
            if (e.b != e.a) rm(e.b);
            e.alive = false;
            nlive--;
        }
    }
    // edges in insertion order (Python dict order)
    std::vector<int> edge_ids() const {
        std::vector<int> out;
        for (const auto& e : pool)
            if (e.alive) out.push_back(e.eid);
        return out;
    }
    // comps: sorted vertex lists, in order of lowest unseen vertex
    std::vector<std::vector<int>> compute_connected_components() const {
        int n = (int)adj.size();
        std::vector<bool> seen(n, false);
        std::vector<std::vector<int>> comps;
        for (int i = 0; i < n; i++) {
            if (seen[i]) continue;
            std::vector<int> comp, stack{i};
            seen[i] = true;
            while (!stack.empty()) {
                int x = stack.back();
                stack.pop_back();
                comp.push_back(x);
                for (int eid : adj[x]) {
                    int y = pool[eid].neighbor(x);
                    if (!seen[y]) {
                        seen[y] = true;
                        stack.push_back(y);
                    }
                }
            }
            std::sort(comp.begin(), comp.end());
            comps.push_back(std::move(comp));
        }
        return comps;
    }
};

// ---------------------------------------------------------------- Router
// scallop/router.py classify + thread (scallop/router.cc; the splittable
// subsetsum branch is off the main loop and not ported)

struct Router {
    int root;
    SpliceGraph& gr;
    const std::vector<GEdge*>& i2e;
    const Cfg& cfg;
    std::vector<std::pair<int, int>> routes;
    std::vector<i64> counts;
    int type = -1;
    i64 degree = -1;
    double ratio = -1.0;
    // insertion-ordered pe2w
    std::vector<std::pair<std::pair<int, int>, double>> pe2w;
    std::map<std::pair<int, int>, int> pe2w_idx;
    // insertion-ordered econf (edge -> confidence increment)
    std::vector<std::pair<GEdge*, double>> econf;
    std::vector<int> u2e;
    std::map<int, int> e2u;
    UGraph ug;
    std::map<int, double> u2w;     // ug edge id -> weight

    Router(int r, SpliceGraph& g, const std::vector<GEdge*>& ie,
           const std::vector<std::pair<std::pair<int, int>, i64>>& mpi,
           const Cfg& c)
        : root(r), gr(g), i2e(ie), cfg(c) {
        for (const auto& kv : mpi) {
            routes.push_back(kv.first);
            counts.push_back(kv.second);
        }
    }

    void pe2w_set_if_absent(const std::pair<int, int>& key, double w) {
        if (pe2w_idx.count(key)) return;
        pe2w_idx[key] = (int)pe2w.size();
        pe2w.push_back({key, w});
    }

    // router.cc:61-171 (plain-vertex branch)
    void classify() {
        assert(gr.in_degree(root) >= 1 && gr.out_degree(root) >= 1);
        build_indices();
        build_bipartite_graph();
        if (gr.in_degree(root) == 1 || gr.out_degree(root) == 1) {
            type = VT_TRIVIAL;
            degree = gr.degree(root);
            return;
        }
        auto vv = ug.compute_connected_components();
        if (vv.size() == 1) {
            type = UNSPLITTABLE_SINGLE;
            degree = (i64)ug.num_edges() - (i64)ug.num_vertices()
                     + 2 * (i64)vv.size();
            return;
        }
        i64 a = 0, b = 0;
        for (const auto& c : vv) {
            if (c.size() == 1) a++;
            else b++;
        }
        type = SPLITTABLE_PURE;
        degree = b - 1 + (a + 1) / 2;
    }

    // router.cc:225-248
    void build_indices() {
        e2u.clear();
        u2e.clear();
        for (GEdge* e = gr.vin[root].head; e; e = e->inext) {
            e2u[e->si] = (int)u2e.size();
            u2e.push_back(e->si);
        }
        for (GEdge* e = gr.vout[root].head; e; e = e->onext) {
            e2u[e->si] = (int)u2e.size();
            u2e.push_back(e->si);
        }
    }

    // router.py _common_abd (sorted sample order)
    static double common_abd(const EdgeInfo& le, const EdgeInfo& re) {
        std::vector<int> common = EdgeInfo::intersect(le.samples, re.samples);
        double abd = 0.0;
        for (int sp : common) {
            auto ia = le.spAbd.find(sp);
            auto ib = re.spAbd.find(sp);
            double a = ia == le.spAbd.end() ? 0.0 : ia->second;
            double b = ib == re.spAbd.end() ? 0.0 : ib->second;
            abd += 0.99 * std::min(a, b) + 0.01 * std::max(a, b);
        }
        return abd;
    }

    // router.cc:1010-1069
    void thread_left_isolate(const std::vector<int>& left_iso,
                             const std::vector<int>& right_all) {
        for (int v : left_iso) {
            GEdge* le = i2e[u2e[v]];
            const EdgeInfo& le_info = le->info;
            int partner = -1;
            double max_abd = 0.0;
            double sum_abd = 0.0;
            for (int r : right_all) {
                GEdge* re = i2e[u2e[r]];
                double ca = common_abd(le_info, re->info);
                sum_abd += ca;
                if (ca > max_abd) {
                    max_abd = ca;
                    partner = r;
                }
            }
            if (partner < 0) continue;
            int e = ug.add_edge(v, partner);
            u2w[e] = max_abd;
            econf.push_back({le, sum_abd > 0 ? std::log(max_abd / sum_abd)
                                             : 0.0});
        }
    }
    // router.cc:1071-1129
    void thread_right_isolate(const std::vector<int>& right_iso,
                              const std::vector<int>& left_all) {
        for (int v : right_iso) {
            GEdge* re = i2e[u2e[v]];
            const EdgeInfo& re_info = re->info;
            int partner = -1;
            double max_abd = 0.0;
            double sum_abd = 0.0;
            for (int ll : left_all) {
                GEdge* le = i2e[u2e[ll]];
                double ca = common_abd(le->info, re_info);
                sum_abd += ca;
                if (ca > max_abd) {
                    max_abd = ca;
                    partner = ll;
                }
            }
            if (partner < 0) continue;
            int e = ug.add_edge(partner, v);
            u2w[e] = max_abd;
            econf.push_back({re, sum_abd > 0 ? std::log(max_abd / sum_abd)
                                             : 0.0});
        }
    }

    // router.cc:250-325
    void build_bipartite_graph() {
        ug = UGraph();
        u2w.clear();
        for (size_t i = 0; i < u2e.size(); i++) ug.add_vertex();
        int l = gr.in_degree(root);
        std::vector<int> left, right;
        for (size_t i = 0; i < u2e.size(); i++) {
            GEdge* e = i2e[u2e[i]];
            if (e->info.count != 0) {
                if ((int)i < l) left.push_back((int)i);
                else right.push_back((int)i);
            }
        }
        for (size_t i = 0; i < routes.size(); i++) {
            int s = e2u[routes[i].first];
            int t = e2u[routes[i].second];
            int e = ug.add_edge(s, t);
            u2w[e] = (double)counts[i];
        }
        std::vector<int> v1, v2;
        for (int i : left)
            if (ug.degree(i) == 0) v1.push_back(i);
        thread_left_isolate(v1, right);
        for (int i : right)
            if (ug.degree(i) == 0) v2.push_back(i);
        thread_right_isolate(v2, left);
    }

    // router.cc:193-223
    void build() {
        assert(type == UNSPLITTABLE_SINGLE || type == SPLITTABLE_PURE);
        thread();
        for (auto& kv : pe2w) {
            if (kv.second < cfg.min_guaranteed_edge_weight)
                kv.second = cfg.min_guaranteed_edge_weight;
        }
    }

    // router.cc:1248-1275
    std::vector<double> balanced_weights_components() {
        auto vv = ug.compute_connected_components();
        std::vector<double> vw(u2e.size(), 0.0);
        int l = gr.in_degree(root);
        for (const auto& cc : vv) {
            double sum1 = 0.0, sum2 = 0.0;
            for (int i : cc) {
                double w = i2e[u2e[i]]->wrt;
                if (i < l) sum1 += w;
                else sum2 += w;
                vw[i] = w;
            }
            if (sum1 <= 0 || sum2 <= 0) continue;
            double r1 = std::sqrt(sum2 / sum1);
            double r2 = std::sqrt(sum1 / sum2);
            for (int i : cc) vw[i] *= (i < l) ? r1 : r2;
        }
        return vw;
    }

    // router.cc:738-857
    void thread() {
        pe2w.clear();
        pe2w_idx.clear();
        std::vector<double> vw = balanced_weights_components();
        double weight_sum = 0.0;
        for (double w : vw) weight_sum += w;
        while (true) {
            if (thread_leaf(vw)) continue;
            if (!thread_turn(vw)) break;
        }
        assert(ug.num_edges() == 0);
        double weight_remain = 0.0;
        for (double w : vw)
            if (w > 0) weight_remain += w;
        ratio = weight_sum > 0 ? weight_remain / weight_sum : 0.0;
        for (const auto& kv : econf)
            kv.first->info.confidence += kv.second;
    }

    // router.cc:859-897
    bool thread_leaf(std::vector<double>& vw) {
        for (int eid : ug.edge_ids()) {
            const UGraph::UEdge& e = ug.pool[eid];
            int s = e.a, t = e.b;
            if (s >= t) std::swap(s, t);
            if (vw[s] < -0.5 || vw[t] < -0.5) continue;
            if (ug.degree(s) == 1 && vw[s] <= vw[t]) {
                pe2w_set_if_absent({u2e[s], u2e[t]}, vw[s]);
                ug.clear_vertex(s);
                vw[t] -= vw[s];
                vw[s] = -1;
                return true;
            }
            if (ug.degree(t) == 1 && vw[t] <= vw[s]) {
                pe2w_set_if_absent({u2e[s], u2e[t]}, vw[t]);
                ug.clear_vertex(t);
                vw[s] -= vw[t];
                vw[t] = -1;
                return true;
            }
        }
        return false;
    }

    // router.cc:899-936
    bool thread_turn(std::vector<double>& vw) {
        int x = -1;
        for (size_t k = 0; k < vw.size(); k++) {
            if (vw[k] < -0.5) continue;
            if (ug.degree((int)k) <= 1) continue;
            if (x != -1 && vw[k] > vw[x]) continue;
            x = (int)k;
        }
        if (x == -1) return false;
        std::vector<int> incident(ug.adj[x]);
        double ssum = 0.0;
        for (int eid : incident) ssum += u2w[eid];
        for (int eid : incident) {
            int t = ug.pool[eid].neighbor(x);
            double w = ssum > 0 ? vw[x] * u2w[eid] / ssum : 0.0;
            std::pair<int, int> key = x < t
                ? std::make_pair(u2e[x], u2e[t])
                : std::make_pair(u2e[t], u2e[x]);
            pe2w_set_if_absent(key, w);
            vw[t] -= w;
        }
        vw[x] = -1;
        ug.clear_vertex(x);
        return true;
    }
};

}  // namespace core
