// core.cpp — the native group assembler and its C ABI.
//
// Port of aletsch_tpu/meta/assembler.py (meta/assembler.{h,cc}): per-bundle
// fragment bridging, joint re-bridging against the combined graph,
// cross-sample junction/boundary/non-splicing support, boundary-extend
// features, and per-graph assembly through the Scallop decomposition.
// Consumed through ctypes (aletsch_tpu/meta/native_core.py); the Python
// pipeline remains the differential oracle.

#include "core_scallop.h"
#include "core_tset.h"

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>

namespace core {

struct CoreOut {
    // per assemble_graph invocation ("group")
    std::vector<i32> g_sid;
    std::vector<i32> g_subindex;
    // per transcript
    std::vector<i32> t_group;
    std::vector<i32> t_pathi;
    std::vector<i32> t_strand;
    std::vector<i64> t_count1;
    std::vector<double> t_cov, t_conf, t_abd;
    std::vector<i32> t_nexons;
    std::vector<i64> exons;          // flat (start, end) pairs
    std::vector<double> feats;       // N_FEATURES per transcript
};

struct GroupAssembler {
    Cfg acfg;                        // assembler parameters (DEFAULT)

    explicit GroupAssembler(const Cfg& c) : acfg(c) {}

    static i64 pack(i64 a, i64 b) {
        return (i64)(((uint64_t)a << 32) | ((uint64_t)b & 0xFFFFFFFFu));
    }

    // assembler.cc:930-944
    void transform(Bundle& bd, bool revising, SpliceGraph& gr) {
        GraphBuilder(bd, acfg).build(gr);
        gr.build_vertex_index();
        if (revising) {
            identify_boundaries(gr, acfg);
            remove_false_boundaries(gr, bd);
            refine_splice_graph(gr);
        }
    }

    // meta/bundle.cc:55-88 (meta/bundle.py bridge; uses the bundle's cfg)
    void bridge(Bundle& bd) {
        SpliceGraph gr;
        GraphBuilder(bd, bd.cfg).build(gr);
        gr.build_vertex_index();
        std::vector<PereadsCluster> vc;
        build_pereads_clusters(gr, bd, bd.cfg.max_reads_partition_gap, vc);
        BridgeSolver bs(gr, vc, bd.cfg, bd.insert_low, bd.insert_high);
        for (size_t k = 0; k < vc.size(); k++) {
            if (bs.opt[k].type <= 0) continue;
            bd.update_bridges(vc[k].frlist, bs.opt[k].chain, bs.opt[k].strand);
        }
    }

    // assembler.cc:117-138 / 255-282
    void stamp_own_sample(SpliceGraph& gr, int sid) {
        for (GEdge* e : gr.edges()) {
            EdgeInfo& ei = e->info;
            ei.samples.assign(1, sid);
            ei.spAbd.clear();
            ei.spAbd[sid] = e->wrt;
            ei.abd = e->wrt;
            ei.count = 1;
        }
    }

    // assembler.cc:152-175 (largest-coverage-first; stable on ties)
    void combine_bundles(Bundle& bx, std::vector<Bundle*>& gv) {
        std::vector<int> order(gv.size());
        for (size_t i = 0; i < gv.size(); i++) order[i] = (int)i;
        std::vector<i64> nseg(gv.size());
        for (size_t i = 0; i < gv.size(); i++)
            nseg[i] = gv[i]->mmap.num_segments();
        std::stable_sort(order.begin(), order.end(),
                         [&nseg](int a, int b) { return nseg[a] > nseg[b]; });
        for (int k : order) bx.combine(*gv[k], true);
    }

    // assembler.cc:977-1018
    void joint_bridge(std::vector<Bundle*>& gv) {
        Bundle cb;
        cb.cfg = acfg;
        cb.copy_meta_information(*gv[0]);
        combine_bundles(cb, gv);
        SpliceGraph gr;
        transform(cb, false, gr);
        PereadsGraphArrays gp;          // one conversion for the whole group
        gp.prepare(gr);
        for (Bundle* bd : gv) {
            std::vector<PereadsCluster> vc;
            build_pereads_clusters(gr, *bd, acfg.max_reads_partition_gap,
                                   vc, &gp);
            if (vc.empty()) continue;
            BridgeSolver bs(gr, vc, acfg, bd->insert_low, bd->insert_high);
            for (size_t j = 0; j < vc.size(); j++) {
                if (bs.opt[j].type <= 0) continue;
                bd->update_bridges(vc[j].frlist, bs.opt[j].chain,
                                   bs.opt[j].strand);
            }
        }
        cb.clear();
    }

    // assembler.cc:375-417; dev_jsum (optional) holds device-computed
    // per-junction abd sums (exactness-gated at export, so substituting
    // them is byte-identical to the sorted-key host sum)
    void junction_support(SpliceGraph& gr,
                          const std::map<i64, std::vector<int>>& junc2sup,
                          const std::map<i64, std::map<int, double>>& sup2abd,
                          const std::map<i64, double>* dev_jsum = nullptr) {
        for (GEdge* e : gr.edges()) {
            int s = e->s, t = e->t;
            if (s == 0 || t == gr.num_vertices() - 1) continue;
            if (gr.vinfo[s].rpos == gr.vinfo[t].lpos) continue;
            i64 p = pack(gr.vinfo[s].rpos, gr.vinfo[t].lpos);
            auto it = junc2sup.find(p);
            if (it == junc2sup.end()) continue;
            EdgeInfo& ei = e->info;
            ei.samples = it->second;           // sorted copy
            const auto& ab = sup2abd.at(p);
            ei.spAbd = ab;
            ei.count = (i64)ei.samples.size();
            double sum = 0.0;
            if (dev_jsum != nullptr) {
                auto dv = dev_jsum->find(p);
                if (dv != dev_jsum->end()) {
                    ei.abd += dv->second;
                    continue;
                }
            }
            for (const auto& kv : ab) sum += kv.second;   // sorted-key order
            ei.abd += sum;
        }
    }

    // assembler.cc:419-462
    void non_splicing_support(int sample_id, SpliceGraph& gr,
                              SpliceGraph& gx) {
        int n = gx.num_vertices() - 1;
        for (GEdge* e : gx.edges()) {
            int s = e->s, t = e->t;
            if (s == 0 || t == n) continue;
            EdgeInfo& ei = e->info;
            if (gx.vinfo[s].rpos != gx.vinfo[t].lpos) continue;
            i64 p = gx.vinfo[t].lpos;
            int k1 = gr.locate_vertex(p - 1);
            int k2 = gr.locate_vertex(p);
            if (k1 < 0 || k2 < 0) continue;
            double w;
            if (k1 == k2) {
                w = gr.vwrt[k1];
            } else if (gr.vinfo[k1].rpos == gr.vinfo[k2].lpos &&
                       gr.edge(k1, k2) != nullptr) {
                w = gr.edge(k1, k2)->wrt;
            } else {
                continue;
            }
            ei.add_sample(sample_id);
            ei.count = (i64)ei.samples.size();
            ei.spAbd[sample_id] += w;
            ei.abd += w;
        }
    }

    // assembler.cc:678-778
    void start_end_support(int sample_id, SpliceGraph& gr, SpliceGraph& gx) {
        int n = gx.num_vertices() - 1;
        std::vector<GEdge*> souts;
        for (GEdge* e = gr.vout[0].head; e; e = e->onext) souts.push_back(e);
        for (GEdge* e : souts) {
            int t = e->t;
            i64 p = gr.vinfo[t].rpos;
            int k = gx.locate_vertex(p - 1);
            if (k < 0) continue;
            GEdge* peb = gx.edge(0, k);
            bool cont = true;
            while (peb == nullptr) {
                k -= 1;
                if (k == 0) { cont = false; break; }
                if (p - gx.vinfo[k].rpos > 200) cont = false;
                if (gx.vinfo[k + 1].lpos != gx.vinfo[k].rpos) cont = false;
                if (gx.edge(k, k + 1) == nullptr) cont = false;
                if (!cont) break;
                peb = gx.edge(0, k);
            }
            if (!cont || peb == nullptr) continue;
            EdgeInfo& ei = peb->info;
            ei.add_sample(sample_id);
            ei.count = (i64)ei.samples.size();
            ei.spAbd[sample_id] += e->wrt;
            ei.abd += e->wrt;
        }
        std::vector<GEdge*> sins;
        int grn = gr.num_vertices() - 1;
        for (GEdge* e = gr.vin[grn].head; e; e = e->inext) sins.push_back(e);
        for (GEdge* e : sins) {
            int s = e->s;
            i64 p = gr.vinfo[s].lpos;
            int k = gx.locate_vertex(p);
            if (k < 0) continue;
            GEdge* peb = gx.edge(k, n);
            bool cont = true;
            while (peb == nullptr) {
                k += 1;
                if (k == n) { cont = false; break; }
                if (gx.vinfo[k].lpos - p > 200) cont = false;
                if (gx.vinfo[k - 1].rpos != gx.vinfo[k].lpos) cont = false;
                if (gx.edge(k - 1, k) == nullptr) cont = false;
                if (!cont) break;
                peb = gx.edge(k, n);
            }
            if (!cont || peb == nullptr) continue;
            EdgeInfo& ei = peb->info;
            ei.add_sample(sample_id);
            ei.count = (i64)ei.samples.size();
            ei.spAbd[sample_id] += e->wrt;
            ei.abd += e->wrt;
        }
    }

    // assembler.cc:781-901
    void boundary_extend(int sample_id, SpliceGraph& gr, SpliceGraph& gx,
                         int pos_type) {
        int n = gr.num_vertices() - 1;
        int gxn = gx.num_vertices() - 1;
        std::vector<GEdge*> souts;
        for (GEdge* e = gr.vout[0].head; e; e = e->onext) souts.push_back(e);
        for (GEdge* e : souts) {
            int t = e->t;
            VertexInfo& vi = gr.vinfo[t];
            int k = -1;
            if (pos_type == 1) k = gx.locate_vertex(vi.lpos);
            else if (pos_type == 2) k = gx.locate_vertex(vi.rpos - 1);
            else if (pos_type == 3) {
                if (t + 1 < n && gr.edge(t, t + 1) != nullptr &&
                    gr.vinfo[t].rpos == gr.vinfo[t + 1].lpos)
                    k = gx.locate_vertex(vi.rpos);
            }
            if (k <= 0 || gx.edge(0, k) != nullptr) continue;
            GEdge* ek = gx.edge(k - 1, k);
            double new_loss;
            if (ek != nullptr && gx.vinfo[k - 1].rpos == gx.vinfo[k].lpos)
                new_loss = gx.get_in_weights(k) - ek->wrt;
            else
                new_loss = gx.get_in_weights(k);
            if (sample_id == -1 && pos_type == 1)
                vi.boundary_merged_loss += new_loss;
            else if (pos_type == 1) vi.boundary_loss1 += new_loss;
            else if (pos_type == 2) vi.boundary_loss2 += new_loss;
            else if (pos_type == 3) vi.boundary_loss3 += new_loss;
        }
        std::vector<GEdge*> sins;
        for (GEdge* e = gr.vin[n].head; e; e = e->inext) sins.push_back(e);
        for (GEdge* e : sins) {
            int s = e->s;
            VertexInfo& vi = gr.vinfo[s];
            int k = -1;
            if (pos_type == 1) k = gx.locate_vertex(vi.rpos - 1);
            else if (pos_type == 2) k = gx.locate_vertex(vi.lpos);
            else if (pos_type == 3) {
                if (s > 1 && gr.edge(s - 1, s) != nullptr &&
                    gr.vinfo[s - 1].rpos == gr.vinfo[s].lpos)
                    k = gx.locate_vertex(vi.lpos - 1);
            }
            if (k < 0 || k == gxn || gx.edge(k, gxn) != nullptr) continue;
            GEdge* ek = k + 1 <= gxn ? gx.edge(k, k + 1) : nullptr;
            double new_loss;
            if (ek != nullptr && gx.vinfo[k].rpos == gx.vinfo[k + 1].lpos)
                new_loss = gx.get_out_weights(k) - ek->wrt;
            else
                new_loss = gx.get_out_weights(k);
            if (sample_id == -1 && pos_type == 1)
                vi.boundary_merged_loss += new_loss;
            else if (pos_type == 1) vi.boundary_loss1 += new_loss;
            else if (pos_type == 2) vi.boundary_loss2 += new_loss;
            else if (pos_type == 3) vi.boundary_loss3 += new_loss;
        }
    }

};

// Resumable group assembly (assembler.cc:33-73 resolve + :107-150
// assemble_single + :177-373 assemble_group + :1075-1136 assemble_graph),
// restructured as an explicit state machine so the greedy max-path DP can
// be paused and computed off-process (wave-batched on the TPU,
// ops/greedy_dp.py).  With device_minv == 0 the machine never pauses and
// advance() reproduces the original single-call behavior exactly — the
// Python pipeline and the differential fuzz pin both modes.
struct GroupRun {
    CoreOut out;
    Cfg acfg;
    std::unique_ptr<GroupAssembler> ga;
    std::vector<std::unique_ptr<Bundle>> bundles;
    std::vector<Bundle*> gv;
    int do_bridge = 1;
    int device_minv = 0;     // 0: host mode (never pause at the greedy DP)

    // ---- machine state (phase: 0 start, 1 independent singles loop,
    //      2 group prologue, 3 per-bundle loop, 4 epilogue, 9 done)
    int phase = 0;
    size_t k = 0;
    int subindex = 0, bx_subindex = 0;
    Bundle bx;
    SpliceGraph gx;
    std::map<i64, std::vector<int>> junc2sup;
    std::map<i64, std::map<int, double>> sup2abd;
    std::vector<std::unique_ptr<SpliceGraph>> grv;
    std::vector<int> subidx;
    PhaseSet px;

    // ---- paused scallop (alive between advance() returning 1 and the
    //      next greedy step); sc_gr holds assemble_single's local graph
    std::unique_ptr<Scallop> sc;
    std::unique_ptr<HyperSet> sc_hs;
    std::unique_ptr<SpliceGraph> sc_gr;
    int sc_group = -1;

    // ---- paused bridging (device_bridge mode): ALL pier-DP instances of
    //      a queue of deferred BridgeSolvers are exported per pause so one
    //      wave dispatch covers the whole phase (ops/bridge_topk.py;
    //      VERDICT r2 #1: one-dispatch-per-wave for the bridge loop too).
    //      Phase 0 queues every bundle's independent solver at once
    //      (bridge/bridge_solver.cc:32-46 reads only its own graph);
    //      the joint phase (assembler.cc:977-1018) queues every bundle's
    //      solver over the SHARED combined graph with the adjacent edges
    //      hoisted once -- serial solvers see the identical graph because
    //      each adds and removes the same adjacent-edge set and
    //      update_bridges never touches the combined graph.
    // ---- paused device ladder (pause kind 4): assemble_graph_begin
    //      stops before phase1; core_ladder_export / core_ladder_consume
    //      run the resolution arms through ops/ladder_kernel.py
    int device_ladder = 0;
    bool ladder_pending = false;

    void ladder_done() {
        ladder_pending = false;
        if (device_minv <= 0 || sc->greedy_done) {
            if (!sc->greedy_done) sc->greedy_finish_host();
            finish_scallop();
        }
    }

    int device_bridge = 0;
    int bphase = 0;         // 0: queue phase-0, 1: queue joint, 2: cleanup
    struct BridgeEntry {
        Bundle* bd = nullptr;
        std::unique_ptr<SpliceGraph> gr;  // phase-0 local graph
        std::vector<PereadsCluster> vc;
        std::unique_ptr<BridgeSolver> bs;
    };
    std::vector<std::unique_ptr<BridgeEntry>> brq;
    size_t brq_i = 0;                     // first entry with unfed insts
    std::unique_ptr<Bundle> br_cb;        // joint combined bundle
    std::unique_ptr<SpliceGraph> br_gx;   // joint combined graph
    std::vector<GEdge*> shared_adj;       // hoisted joint adjacent edges

    // meta/bundle.cc:55-88 / assembler.cc:977-1018 restructured around the
    // deferred BridgeSolver; byte-identical to GroupAssembler::bridge /
    // joint_bridge when every instance is solved (host or device)
    void queue_bridge(Bundle& bd, bool joint) {
        std::unique_ptr<BridgeEntry> en(new BridgeEntry());
        en->bd = &bd;
        const Cfg& bcfg = joint ? acfg : bd.cfg;
        if (!joint) {
            en->gr.reset(new SpliceGraph());
            GraphBuilder(bd, bd.cfg).build(*en->gr);
            en->gr->build_vertex_index();
        }
        SpliceGraph& g = joint ? *br_gx : *en->gr;
        build_pereads_clusters(g, bd, bcfg.max_reads_partition_gap, en->vc);
        if (joint && en->vc.empty()) return;   // joint_bridge skips empty vc
        en->bs.reset(new BridgeSolver(g, en->vc, bcfg, bd.insert_low,
                                      bd.insert_high, /*defer=*/true,
                                      joint ? &shared_adj : nullptr));
        if (en->bs->insts_done()) {
            finish_entry(*en);
            return;
        }
        brq.push_back(std::move(en));
    }

    void finish_entry(BridgeEntry& en) {
        en.bs->finalize();
        for (size_t j = 0; j < en.vc.size(); j++) {
            if (en.bs->opt[j].type <= 0) continue;
            en.bd->update_bridges(en.vc[j].frlist, en.bs->opt[j].chain,
                                  en.bs->opt[j].strand);
        }
        en.bs.reset();
        en.gr.reset();
        std::vector<PereadsCluster>().swap(en.vc);
    }

    bool bridge_queued() const { return brq_i < brq.size(); }

    i64 bridge_pending() const {
        i64 n = 0;
        for (size_t i = brq_i; i < brq.size(); i++)
            n += (i64)brq[i]->bs->pending();
        return n;
    }

    // export the j-th remaining instance (flattened queue order) without
    // advancing; 0 = that instance is device-ineligible
    int bridge_export_at(i64 j, i32* P, i32* Wt, i32* Lv, i32* tgt,
                         int V, int E, int T, int K, int S) {
        for (size_t i = brq_i; i < brq.size(); i++) {
            BridgeSolver& bs = *brq[i]->bs;
            i64 p = (i64)bs.pending();
            if (j < p)
                return bs.export_inst_at(bs.inst_i + (size_t)j, P, Wt, Lv,
                                         tgt, V, E, T, K, S);
            j -= p;
        }
        return 0;
    }

    // after the current solver consumed one instance (device or host)
    void bridge_feed_done() {
        BridgeEntry& en = *brq[brq_i];
        if (en.bs->insts_done()) {
            finish_entry(en);
            brq_i++;
        }
    }

    void joint_setup() {
        br_cb.reset(new Bundle());
        br_cb->cfg = acfg;
        br_cb->copy_meta_information(*gv[0]);
        ga->combine_bundles(*br_cb, gv);
        br_gx.reset(new SpliceGraph());
        ga->transform(*br_cb, false, *br_gx);
        // hoisted add_adjacent_edges (bridge_solver.cc:71-95): shared by
        // every joint solver, removed in the bphase-2 cleanup
        shared_adj.clear();
        for (int i = 1; i < br_gx->num_vertices() - 2; i++) {
            if (br_gx->edge(i, i + 1) != nullptr) continue;
            GEdge* e = br_gx->add_edge(i, i + 1);
            e->wrt = 0.5;
            e->info.weight = 0.5;
            shared_adj.push_back(e);
        }
    }

    // ---- paused cross-sample support reduce (device_support mode): after
    //      phase 2 the junc2sup/sup2abd maps are final; the per-junction
    //      abd sums (assembler.cc:375-417 `ei.abd += sum`) run as one
    //      wave-batched sample-axis reduce on the device (ops/support.py).
    int device_support = 0;
    bool support_pending = false;
    std::map<i64, double> dev_jsum;
    std::vector<uint8_t> sup_gate;      // per exported junction: f32-exact?
    int sup_exported = 0;

    // Fill one [NS, J] f32 batch row with per-(sample-slot, junction)
    // weights, ascending junction key, map order within a junction (both
    // orders are irrelevant to the sum; the exactness gate below makes the
    // f32 sum equal the host's sorted-key f64 sum bit-for-bit).  Returns
    // the number of junctions exported (0 = nothing to offload).
    int support_export(float* jw, i32 NS, i32 J) {
        for (i64 r = 0; r < (i64)NS * J; r++) jw[r] = 0.0f;
        sup_gate.assign(sup2abd.size(), 0);
        int j = 0;
        int usable = 0;
        for (const auto& kv : sup2abd) {
            if (j >= J) break;          // overflow junctions stay on host
            const auto& ab = kv.second;
            bool ok = (i32)ab.size() <= NS;
            double mx = 0.0;
            if (ok) {
                for (const auto& sw : ab) {
                    double w = sw.second;
                    // gate: non-negative integral weights whose total is
                    // exactly representable in f32 (sum of <= NS integers
                    // each <= mx stays < 2^24)
                    if (w < 0 || w != (double)(i64)w) { ok = false; break; }
                    if (w > mx) mx = w;
                }
            }
            if (ok && mx * (double)ab.size() >= 16777216.0) ok = false;
            if (ok) {
                int r = 0;
                for (const auto& sw : ab)
                    jw[(size_t)r++ * J + j] = (float)sw.second;
                usable++;
            }
            sup_gate[j] = ok ? 1 : 0;
            j++;
        }
        sup_exported = j;
        return usable;
    }

    void support_consume(const float* sums) {
        int j = 0;
        for (const auto& kv : sup2abd) {
            if (j >= sup_exported) break;
            if (sup_gate[j]) dev_jsum[kv.first] = (double)sums[j];
            j++;
        }
        support_pending = false;
    }

    // phase transition after all bridging (mirrors the original phase-0
    // tail exactly)
    void post_bridge() {
        if (gv.size() == 1) {
            phase = 1;
            k = 0;
        } else if (gv.size() >= 2) {
            phase = 2;
        } else {
            phase = 9;
        }
    }

    // assembler.cc:177-231 collect_support lambda
    void collect_support(SpliceGraph& gr, int sid) {
        for (GEdge* e : gr.edges()) {
            int s = e->s, t = e->t;
            EdgeInfo& ei = e->info;
            ei.samples.assign(1, sid);
            ei.spAbd.clear();
            ei.spAbd[sid] = e->wrt;
            ei.abd = e->wrt;
            ei.count = 1;
            if (s == 0 || t == gr.num_vertices() - 1) continue;
            i64 p0r = gr.vinfo[s].rpos;
            i64 p0l = gr.vinfo[t].lpos;
            if (p0r == p0l) continue;
            i64 p = GroupAssembler::pack(p0r, p0l);
            auto& sset = junc2sup[p];
            auto it = std::lower_bound(sset.begin(), sset.end(), sid);
            if (it == sset.end() || *it != sid) sset.insert(it, sid);
            sup2abd[p][sid] = e->wrt;
        }
    }

    // assembler.cc:1075-1136 up to the Scallop; pauses in device mode
    void assemble_graph_begin(SpliceGraph& g, PhaseSet& ps, int sid,
                              int subindex_) {
        g.extend_strands();
        std::map<i64, i64> smap =
            group_start_boundaries(g, acfg.max_group_boundary_distance);
        std::map<i64, i64> tmap =
            group_end_boundaries(g, acfg.max_group_boundary_distance);
        ps.project_boundaries(smap, tmap);
        sc_hs.reset(new HyperSet());
        sc_hs->init_from_phase_set(g, ps);
        sc_hs->filter_nodes(g);
        sc_group = (int)out.g_sid.size();
        out.g_sid.push_back(sid);
        out.g_subindex.push_back(subindex_);
        sc.reset(new Scallop(g, *sc_hs, acfg));
        if (device_ladder) {
            // pause kind 4: the batched device ladder consumes the
            // resolution-arm decisions before phase1 completes
            ladder_pending = true;
            return;
        }
        sc->assemble_phase1();
        if (device_minv <= 0 || sc->greedy_done) {
            if (!sc->greedy_done) sc->greedy_finish_host();
            finish_scallop();
        }
        // else: paused; the caller feeds greedy tables via the C ABI
    }

    void finish_scallop() {
        std::vector<OutTranscript> ts;
        sc->assemble_phase2(ts, sc_group);
        for (OutTranscript& t : ts) {
            out.t_group.push_back(t.group);
            out.t_pathi.push_back(t.path_i);
            out.t_strand.push_back((i32)t.strand);
            out.t_count1.push_back(t.count1);
            out.t_cov.push_back(t.coverage);
            out.t_conf.push_back(t.conf);
            out.t_abd.push_back(t.abd);
            out.t_nexons.push_back((i32)t.exons.size());
            for (auto& ab : t.exons) {
                out.exons.push_back(ab.first);
                out.exons.push_back(ab.second);
            }
            size_t base = out.feats.size();
            out.feats.resize(base + N_FEATURES);
            features_to_array(t.f, out.feats.data() + base);
        }
        sc.reset();
        sc_hs.reset();
        sc_gr.reset();
        sc_group = -1;
    }

    // assembler.cc:107-150 (bd.clear() moved before the scallop finishes;
    // the scallop never reads the bundle)
    void assemble_single_begin(Bundle& bd, int subindex_) {
        sc_gr.reset(new SpliceGraph());
        SpliceGraph& g = *sc_gr;
        ga->transform(bd, true, g);
        g.reads = (i64)bd.frgs.size();
        g.subgraph = 1;
        ga->stamp_own_sample(g, bd.sample_id);
        PhaseSet ps;
        bd.build_phase_set(ps, g);
        assemble_graph_begin(g, ps, bd.sample_id, subindex_);
        bd.clear();
    }

    // run until the next pause (1 = greedy, 2 = bridge, 3 = support,
    // 4 = ladder) or completion (0)
    int advance() {
        while (true) {
            if (sc && ladder_pending) return 4;
            if (sc) return 1;
            if (bridge_queued()) return 2;
            if (support_pending) return 3;
            if (phase == 0) {
                if (!do_bridge) {
                    phase = 1;
                    k = 0;
                    continue;
                }
                if (!device_bridge) {
                    for (Bundle* bd : gv) ga->bridge(*bd);
                    if (gv.size() >= 2) ga->joint_bridge(gv);
                    post_bridge();
                    continue;
                }
                // device bridging: ONE pause per phase with every
                // solver's instances queued (wave-batched dispatch)
                if (bphase == 0) {
                    for (Bundle* bd : gv) queue_bridge(*bd, false);
                    bphase = 1;
                } else if (bphase == 1) {
                    if (gv.size() >= 2) {
                        joint_setup();
                        for (Bundle* bd : gv) queue_bridge(*bd, true);
                    }
                    bphase = 2;
                } else {
                    if (br_cb) {
                        br_cb->clear();
                        br_cb.reset();
                    }
                    if (br_gx) {
                        for (GEdge* e : shared_adj) br_gx->remove_edge(e);
                        br_gx.reset();
                    }
                    shared_adj.clear();
                    brq.clear();
                    brq_i = 0;
                    post_bridge();
                }
            } else if (phase == 1) {
                if (k >= gv.size()) { phase = 9; continue; }
                Bundle* bd = gv[k];
                k++;
                assemble_single_begin(*bd, 0);
            } else if (phase == 2) {
                bx.cfg = acfg;
                bx.copy_meta_information(*gv[0]);
                ga->combine_bundles(bx, gv);
                bx_subindex = subindex;
                subindex++;
                ga->transform(bx, false, gx);
                gx.reads = (i64)bx.frgs.size();
                gx.subgraph = (i64)gv.size();
                collect_support(gx, -1);
                for (Bundle* bd : gv) {
                    int si = subindex;
                    subindex++;
                    grv.push_back(std::unique_ptr<SpliceGraph>(
                        new SpliceGraph()));
                    SpliceGraph& g = *grv.back();
                    ga->transform(*bd, true, g);
                    g.reads = (i64)bd->frgs.size();
                    g.subgraph = (i64)gv.size();
                    if (getenv("DBG_BUNDLE") && bd->hits.size() <= 3) {
                        fprintf(stderr, "BUNDLE sample=%d nhits=%zu nfrgs=%zu"
                                " lpos=%lld rpos=%lld strand=%c\n",
                                bd->sample_id, bd->hits.size(),
                                bd->frgs.size(), (long long)bd->lpos,
                                (long long)bd->rpos, bd->strand);
                        for (const HitRow& h : bd->hits)
                            fprintf(stderr, "  HIT pos=%lld rpos=%lld "
                                    "mpos=%lld isize=%lld hid=%lld\n",
                                    (long long)h.pos, (long long)h.rpos,
                                    (long long)h.mpos, (long long)h.isize,
                                    (long long)h.hid);
                        for (const auto& f : bd->frgs)
                            fprintf(stderr, "  FRG %lld %lld %lld\n",
                                    (long long)f[0], (long long)f[1],
                                    (long long)f[2]);
                    }
                    collect_support(g, bd->sample_id);
                    subidx.push_back(si);
                }
                phase = 3;
                k = 0;
                // junc2sup/sup2abd are final here: offload the abd sums
                if (device_support && !sup2abd.empty())
                    support_pending = true;
            } else if (phase == 3) {
                if (k >= gv.size()) { phase = 4; continue; }
                Bundle* bd = gv[k];
                SpliceGraph& g = *grv[k];
                ga->junction_support(g, junc2sup, sup2abd, &dev_jsum);
                for (size_t j = 0; j < gv.size(); j++) {
                    SpliceGraph& g1 = *grv[j];
                    ga->start_end_support(gv[j]->sample_id, g1, g);
                    ga->non_splicing_support(gv[j]->sample_id, g1, g);
                    ga->boundary_extend(gv[j]->sample_id, g, g1, 1);
                    ga->boundary_extend(gv[j]->sample_id, g, g1, 2);
                    ga->boundary_extend(gv[j]->sample_id, g, g1, 3);
                }
                PhaseSet ps;
                bd->build_phase_set(ps, g);
                px.combine(ps);
                ga->start_end_support(bd->sample_id, g, gx);
                ga->non_splicing_support(bd->sample_id, g, gx);
                ga->boundary_extend(-1, g, gx, 1);
                int si = subidx[k];
                k++;
                assemble_graph_begin(g, ps, bd->sample_id, si);
                bd->clear();
            } else if (phase == 4) {
                bx.clear();
                ga->junction_support(gx, junc2sup, sup2abd, &dev_jsum);
                phase = 9;
                assemble_graph_begin(gx, px, -1, bx_subindex);
            } else {
                return 0;
            }
        }
    }
};

}  // namespace core

// ------------------------------------------------------------------ C ABI

using core::i32;
using core::i64;

extern "C" {

static core::GroupRun* make_group_run(
    i32 n_bundles, i32 do_bridge,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls, i32 device_minv,
    i32 device_bridge, i32 device_support) {
    core::GroupRun* run = new core::GroupRun();
    for (i32 b = 0; b < n_bundles; b++) {
        run->bundles.push_back(
            std::unique_ptr<core::Bundle>(new core::Bundle()));
        core::Bundle& bd = *run->bundles.back();
        bd.cfg = core::cfg_from_arrays(cfg_ints + (size_t)b * core::CFG_NI,
                                       cfg_dbls + (size_t)b * core::CFG_ND);
        bd.sample_id = sample_id[b];
        bd.strand = (char)strand[b];
        bd.insert_low = ins_low[b];
        bd.insert_high = ins_high[b];
        bd.init_from_scan(fixed_p[b], nh[b], coords_p[b],
                          mev_p[b], mev_cnt[b],
                          iev_p[b], iev_cnt[b],
                          frg_p[b], frg_cnt[b]);
        bd.tid = 0;
        bd.lpos = lpos[b];
        bd.rpos = rpos[b];
        run->gv.push_back(&bd);
    }
    run->acfg = core::cfg_from_arrays(
        cfg_ints + (size_t)n_bundles * core::CFG_NI,
        cfg_dbls + (size_t)n_bundles * core::CFG_ND);
    run->ga.reset(new core::GroupAssembler(run->acfg));
    run->do_bridge = do_bridge;
    run->device_minv = device_minv;
    run->device_bridge = device_bridge;
    run->device_support = device_support;
    return run;
}

void* core_resolve_group(
    i32 n_bundles, i32 do_bridge,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls) {
    core::GroupRun* run = make_group_run(
        n_bundles, do_bridge, nh, fixed_p, coords_p, mev_p, mev_cnt,
        iev_p, iev_cnt, frg_p, frg_cnt, sample_id, strand, lpos, rpos,
        ins_low, ins_high, cfg_ints, cfg_dbls, 0, 0, 0);
    run->advance();
    core::CoreOut* out = new core::CoreOut(std::move(run->out));
    delete run;
    return out;
}

// ---- multithreaded batch: assemble MANY groups in one call on a native
//      thread pool (no GIL involvement; the per-group ~2-3 ms ctypes
//      crossing and Python future overhead made pool-threading the
//      per-group calls a measured loss on the 2-core host).  All
//      bundle-level arrays are the per-group arrays CONCATENATED in
//      group order (grp_nb[g] bundles per group); cfg arrays are the
//      per-group (nb_g + 1) blocks concatenated.  Outputs are one
//      CoreOut per group, fetched in group order (determinism).

struct BatchOut {
    std::vector<core::CoreOut> outs;
};

// A launched batch: owns COPIES of every small per-bundle index array (the
// ctypes pointer tables and scalar arrays on the Python side are
// function-local and die at return), so the caller only needs to keep the
// big scanner data arrays (fixed/coords/mev/iev/frg payloads) alive until
// core_batch_join.  Used both synchronously (core_resolve_groups_mt) and
// asynchronously (core_resolve_groups_mt_async + core_batch_join) — the
// async form lets the incubator overlap region r's native assembly with
// region r-1's Python-side replay (meta/incubator.py pipelined waves).
struct BatchJob {
    BatchOut* bo = nullptr;
    std::vector<std::thread> ts;
    i32 n_groups = 0, do_bridge = 0;
    std::vector<i32> grp_nb, nh, sample_id, strand;
    std::vector<const i32*> fixed_p, coords_p, mev_p, iev_p, frg_p;
    std::vector<i64> mev_cnt, iev_cnt, frg_cnt, lpos, rpos,
                     ins_low, ins_high, cfg_ints;
    std::vector<double> cfg_dbls;
    std::vector<size_t> boff, coff;
    std::atomic<i32> next{0};
    // deferred native-set merge: when m_merge is set (before spawn), the
    // worker that completes the wave's LAST group replays every group's
    // transcripts into its target set in group order — the ~0.6 s
    // main-thread replay then overlaps the next region's Python work.
    // Targets are safe to write here: the Python caller never touches the
    // wave's region sets between launch and join (meta/incubator.py
    // _region_start/_region_finish pipeline contract).
    bool m_merge = false;
    std::vector<void*> m_tgt;
    std::vector<i64> m_rid, m_gid, m_inst;
    std::vector<i32> m_skip;
    std::string m_chrm;
    std::atomic<i32> done{0};

    void run_merge();

    void work() {
        for (;;) {
            i32 g = next.fetch_add(1);
            if (g >= n_groups) {
                return;
            }
            size_t b = boff[g], c = coff[g];
            core::GroupRun* run = make_group_run(
                grp_nb[g], do_bridge, nh.data() + b, fixed_p.data() + b,
                coords_p.data() + b,
                mev_p.data() + b, mev_cnt.data() + b,
                iev_p.data() + b, iev_cnt.data() + b,
                frg_p.data() + b, frg_cnt.data() + b,
                sample_id.data() + b, strand.data() + b,
                lpos.data() + b, rpos.data() + b,
                ins_low.data() + b, ins_high.data() + b,
                cfg_ints.data() + c * core::CFG_NI,
                cfg_dbls.data() + c * core::CFG_ND,
                0, 0, 0);
            run->advance();
            bo->outs[g] = std::move(run->out);
            delete run;
            if (m_merge && done.fetch_add(1) + 1 == n_groups)
                run_merge();
        }
    }
};

static BatchJob* make_batch_job(
    i32 n_groups, i32 do_bridge,
    const i32* grp_nb,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls) {
    BatchJob* job = new BatchJob();
    job->bo = new BatchOut();
    job->bo->outs.resize(n_groups);
    job->n_groups = n_groups;
    job->do_bridge = do_bridge;
    job->boff.assign(n_groups + 1, 0);
    job->coff.assign(n_groups + 1, 0);
    for (i32 g = 0; g < n_groups; g++) {
        job->boff[g + 1] = job->boff[g] + (size_t)grp_nb[g];
        job->coff[g + 1] = job->coff[g] + (size_t)grp_nb[g] + 1;
    }
    size_t nb = job->boff[n_groups], nc = job->coff[n_groups];
    job->grp_nb.assign(grp_nb, grp_nb + n_groups);
    job->nh.assign(nh, nh + nb);
    job->sample_id.assign(sample_id, sample_id + nb);
    job->strand.assign(strand, strand + nb);
    job->fixed_p.assign(fixed_p, fixed_p + nb);
    job->coords_p.assign(coords_p, coords_p + nb);
    job->mev_p.assign(mev_p, mev_p + nb);
    job->iev_p.assign(iev_p, iev_p + nb);
    job->frg_p.assign(frg_p, frg_p + nb);
    job->mev_cnt.assign(mev_cnt, mev_cnt + nb);
    job->iev_cnt.assign(iev_cnt, iev_cnt + nb);
    job->frg_cnt.assign(frg_cnt, frg_cnt + nb);
    job->lpos.assign(lpos, lpos + nb);
    job->rpos.assign(rpos, rpos + nb);
    job->ins_low.assign(ins_low, ins_low + nb);
    job->ins_high.assign(ins_high, ins_high + nb);
    job->cfg_ints.assign(cfg_ints, cfg_ints + nc * core::CFG_NI);
    job->cfg_dbls.assign(cfg_dbls, cfg_dbls + nc * core::CFG_ND);
    return job;
}

static void batch_job_spawn(BatchJob* job, i32 nthreads, bool run_inline) {
    int k = 1;
    if (nthreads > 1 && job->n_groups > 1)
        k = nthreads < job->n_groups ? nthreads : job->n_groups;
    int spawn = run_inline ? k - 1 : k;
    for (int i = 0; i < spawn; i++)
        job->ts.emplace_back([job]() { job->work(); });
    if (run_inline) job->work();
}

void* core_resolve_groups_mt(
    i32 n_groups, i32 nthreads, i32 do_bridge,
    const i32* grp_nb,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls) {
    BatchJob* job = make_batch_job(
        n_groups, do_bridge, grp_nb, nh, fixed_p, coords_p, mev_p, mev_cnt,
        iev_p, iev_cnt, frg_p, frg_cnt, sample_id, strand, lpos, rpos,
        ins_low, ins_high, cfg_ints, cfg_dbls);
    batch_job_spawn(job, nthreads, true);
    for (auto& t : job->ts) t.join();
    BatchOut* bo = job->bo;
    delete job;
    return bo;
}

// async form: spawn nthreads workers and return immediately; the caller
// must keep the scanner payload arrays alive until core_batch_join, which
// joins the workers and returns the BatchOut handle (pass to
// core_batch_sizes/fill/free as usual).
void* core_resolve_groups_mt_async(
    i32 n_groups, i32 nthreads, i32 do_bridge,
    const i32* grp_nb,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls) {
    BatchJob* job = make_batch_job(
        n_groups, do_bridge, grp_nb, nh, fixed_p, coords_p, mev_p, mev_cnt,
        iev_p, iev_cnt, frg_p, frg_cnt, sample_id, strand, lpos, rpos,
        ins_low, ins_high, cfg_ints, cfg_dbls);
    batch_job_spawn(job, nthreads, false);
    return job;
}

void* core_batch_join(void* jh) {
    BatchJob* job = (BatchJob*)jh;
    for (auto& t : job->ts) t.join();
    BatchOut* bo = job->bo;
    delete job;
    return bo;
}

void core_batch_sizes(void* h, i32 g, i64* out3) {
    core::CoreOut& o = ((BatchOut*)h)->outs[g];
    out3[0] = (i64)o.g_sid.size();
    out3[1] = (i64)o.t_group.size();
    out3[2] = (i64)o.exons.size();
}

void core_out_fill(void* h, i32* g_sid, i32* g_subindex,
                   i32* t_group, i32* t_pathi, i32* t_strand,
                   i64* t_count1, double* t_cov, double* t_conf,
                   double* t_abd, i32* t_nexons, i64* exons, double* feats);

void core_batch_fill(void* h, i32 g, i32* g_sid, i32* g_subindex,
                     i32* t_group, i32* t_pathi, i32* t_strand,
                     i64* t_count1, double* t_cov, double* t_conf,
                     double* t_abd, i32* t_nexons, i64* exons,
                     double* feats) {
    core_out_fill(&((BatchOut*)h)->outs[g], g_sid, g_subindex, t_group,
                  t_pathi, t_strand, t_count1, t_cov, t_conf, t_abd,
                  t_nexons, exons, feats);
}

void core_batch_free(void* h) { delete (BatchOut*)h; }

// ---- batch capture: serialize one core_resolve_groups_mt argument set to
// a flat binary file so a standalone statically-linked driver
// (native/replay_batch.cpp) can replay the exact production workload under
// gprof.  Diagnostic only (ALETSCH_CAPTURE_BATCH on the Python side);
// never on the production path.
void core_batch_capture(
    i32 n_groups, i32 do_bridge,
    const i32* grp_nb, const i32* nh,
    const i32* const* fixed_p, const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls,
    const char* path) {
    FILE* fp = fopen(path, "wb");
    if (!fp) return;
    size_t nb = 0;
    for (i32 g = 0; g < n_groups; g++) nb += (size_t)grp_nb[g];
    size_t nc = nb + (size_t)n_groups;
    i64 hdr[3] = {0x414c424154434801LL, n_groups, do_bridge};
    fwrite(hdr, sizeof(i64), 3, fp);
    fwrite(grp_nb, sizeof(i32), n_groups, fp);
    fwrite(nh, sizeof(i32), nb, fp);
    fwrite(sample_id, sizeof(i32), nb, fp);
    fwrite(strand, sizeof(i32), nb, fp);
    fwrite(mev_cnt, sizeof(i64), nb, fp);
    fwrite(iev_cnt, sizeof(i64), nb, fp);
    fwrite(frg_cnt, sizeof(i64), nb, fp);
    fwrite(lpos, sizeof(i64), nb, fp);
    fwrite(rpos, sizeof(i64), nb, fp);
    fwrite(ins_low, sizeof(i64), nb, fp);
    fwrite(ins_high, sizeof(i64), nb, fp);
    fwrite(cfg_ints, sizeof(i64), nc * core::CFG_NI, fp);
    fwrite(cfg_dbls, sizeof(double), nc * core::CFG_ND, fp);
    for (size_t b = 0; b < nb; b++) {
        i64 nfix = (i64)nh[b] * 25;
        // per-bundle coords length: the DP touches coords only through
        // row[17] + 2*row[18] .. +row[19] slices (core_base.h
        // init_from_scan, core_solve.h pereads export)
        i64 clen = 0;
        for (i32 j = 0; j < nh[b]; j++) {
            const i32* row = fixed_p[b] + 25 * j;
            i64 end = (i64)row[17] + 2 * (i64)row[18] + (i64)row[19];
            if (end > clen) clen = end;
        }
        i64 sizes[2] = {nfix, clen};
        fwrite(sizes, sizeof(i64), 2, fp);
        fwrite(fixed_p[b], sizeof(i32), nfix, fp);
        fwrite(coords_p[b], sizeof(i32), clen, fp);
        fwrite(mev_p[b], sizeof(i32), 2 * mev_cnt[b], fp);
        fwrite(iev_p[b], sizeof(i32), 2 * iev_cnt[b], fp);
        fwrite(frg_p[b], sizeof(i32), 2 * frg_cnt[b], fp);
    }
    fclose(fp);
}

// whole-wave fetch: sizes and concatenated outputs in ONE call each
// (replaces 2 ctypes crossings + 14 numpy allocations per group on the
// Python replay path — ~4k crossings per production run)
void core_batch_sizes_all(void* h, i32 n_groups, i64* out3n) {
    BatchOut* bo = (BatchOut*)h;
    for (i32 g = 0; g < n_groups; g++) {
        core::CoreOut& o = bo->outs[g];
        out3n[3 * g + 0] = (i64)o.g_sid.size();
        out3n[3 * g + 1] = (i64)o.t_group.size();
        out3n[3 * g + 2] = (i64)o.exons.size();
    }
}

void core_batch_fill_all(void* h, i32 n_groups, i32* g_sid, i32* g_subindex,
                         i32* t_group, i32* t_pathi, i32* t_strand,
                         i64* t_count1, double* t_cov, double* t_conf,
                         double* t_abd, i32* t_nexons, i64* exons,
                         double* feats) {
    BatchOut* bo = (BatchOut*)h;
    size_t go = 0, to = 0, eo = 0, fo = 0;
    for (i32 g = 0; g < n_groups; g++) {
        core::CoreOut& o = bo->outs[g];
        core_out_fill(&o, g_sid + go, g_subindex + go, t_group + to,
                      t_pathi + to, t_strand + to, t_count1 + to,
                      t_cov + to, t_conf + to, t_abd + to, t_nexons + to,
                      exons + eo, feats + fo);
        go += o.g_sid.size();
        to += o.t_group.size();
        eo += o.exons.size();
        fo += o.feats.size();
    }
}

// Per-transcript intron-chain bucket hashes for the whole wave, in the
// same transcript order as core_batch_fill_all.  Matches the Python
// formula (io/gtf.py get_intron_chain_hashing, transcript.cc:183-201)
// EXCEPT the trailing +1, which the replay adds in unbounded Python
// arithmetic so a wrap at 2^64 stays bit-identical with the Python path.
void core_batch_hashes(void* h, i32 n_groups, uint64_t* out) {
    BatchOut* bo = (BatchOut*)h;
    size_t to = 0, eo = 0;
    for (i32 g = 0; g < n_groups; g++) {
        core::CoreOut& o = bo->outs[g];
        size_t nt = o.t_nexons.size();
        const i64* e = o.exons.data();
        size_t le = 0;
        for (size_t k = 0; k < nt; k++) {
            i32 ne = o.t_nexons[k];
            uint64_t hh = 0;
            if (ne == 1) {
                hh = (uint64_t)((e[le] + e[le + 1]) / 10000);
            } else if (ne >= 2) {
                uint64_t x = 0xcbf29ce484222325ULL;  // FNV-1a (utils/seqs.py)
                for (i32 j = 1; j < ne; j++) {
                    x ^= (uint64_t)e[le + 2 * (size_t)(j - 1) + 1];
                    x *= 0x100000001b3ULL;
                    x ^= (uint64_t)e[le + 2 * (size_t)j];
                    x *= 0x100000001b3ULL;
                }
                hh = x;
            }
            out[to + k] = hh;
            le += 2 * (size_t)ne;
        }
        to += nt;
        eo += o.exons.size();
    }
}

// ---- device-paused group assembly (wave-batched greedy DP on the TPU;
//      orchestrated by aletsch_tpu/meta/native_core.py + ops/greedy_dp.py)

void* core_group_start(
    i32 n_bundles, i32 do_bridge,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls, i32 device_minv,
    i32 device_bridge, i32 device_support) {
    return make_group_run(
        n_bundles, do_bridge, nh, fixed_p, coords_p, mev_p, mev_cnt,
        iev_p, iev_cnt, frg_p, frg_cnt, sample_id, strand, lpos, rpos,
        ins_low, ins_high, cfg_ints, cfg_dbls,
        device_minv > 0 ? device_minv : 1, device_bridge, device_support);
}

// run to the first pause (1 = greedy, 2 = bridge, 3 = support reduce,
// 4 = ladder) or completion (0)
i32 core_group_advance(void* h) {
    return ((core::GroupRun*)h)->advance();
}

// ---- paused device ladder (ops/ladder_kernel.py; pause kind 4)

// enable ladder pauses for this run (call before the first advance)
void core_group_set_ladder(void* h, i32 on) {
    ((core::GroupRun*)h)->device_ladder = on;
}

// fill one batch row with the pre-ladder dense state; V > 0 or 0 when
// ineligible (caller then uses core_ladder_solve_host)
i32 core_ladder_export(void* h, i32* esrc, i32* edst, double* ewrt,
                       i32* estr, i32* esin, i32* esout, uint8_t* ealive,
                       i32* meta3, uint8_t* nz, i32* hedge, i32* hlen,
                       double* scal4, i32 maxv, i32 emax, i32 hmax,
                       i32 lmax, i32 dmax) {
    core::GroupRun* r = (core::GroupRun*)h;
    if (!r->sc || !r->ladder_pending) return 0;
    return r->sc->ladder_export(esrc, edst, ewrt, estr, esin, esout,
                                ealive, meta3, nz, hedge, hlen, scal4,
                                maxv, emax, hmax, lmax, dmax);
}

// consume the device decision log (mode 0 trust / 1 verify; status != 0
// means device overflow) and finish phase1; returns the next pause kind
i32 core_ladder_consume(void* h, const i32* arm, const i32* tgt,
                        i32 ndec, i32 status, i32 mode, i64* stats2) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->sc->ladder_consume(arm, tgt, ndec, status, mode, stats2);
    r->ladder_done();
    return r->advance();
}

// ineligible graph: run phase1 on host; returns the next pause kind
i32 core_ladder_solve_host(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->sc->assemble_phase1();
    r->ladder_done();
    return r->advance();
}

// ---- paused cross-sample support reduce (wave-batched sample-axis sum on
//      the device, ops/support.py).  Export fills one [NS, J] f32 batch
//      row; step consumes the [J] per-junction sums; solve_host skips the
//      offload (junction_support then falls back to the host sums).

i32 core_support_export(void* h, float* jw, i32 NS, i32 J) {
    core::GroupRun* r = (core::GroupRun*)h;
    if (!r->support_pending) return 0;
    return r->support_export(jw, NS, J);
}

i32 core_support_step(void* h, const float* sums) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->support_consume(sums);
    return r->advance();
}

i32 core_support_solve_host(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->support_pending = false;
    return r->advance();
}

// ---- device-paused bridging DP (wave-batched top-K stack DP on the TPU;
//      ops/bridge_topk.py).  Export fills one padded batch row for the
//      current pier-DP instance; step consumes the device stacks + parent
//      tables; solve_host is the per-instance fallback.  All return like
//      core_group_advance.

// number of unsolved pier-DP instances across the paused queue
i64 core_bridge_pending(void* h) {
    return ((core::GroupRun*)h)->bridge_pending();
}

// export the j-th remaining instance (flattened queue order, no advance)
i32 core_bridge_export_at(void* h, i64 j, i32* P, i32* Wt, i32* Lv,
                          i32* tgt, i32 V, i32 E, i32 T, i32 K, i32 S) {
    return ((core::GroupRun*)h)->bridge_export_at(j, P, Wt, Lv, tgt,
                                                  V, E, T, K, S);
}

i32 core_bridge_export(void* h, i32* P, i32* Wt, i32* Lv, i32* tgt,
                       i32 V, i32 E, i32 T, i32 K, i32 S) {
    core::GroupRun* r = (core::GroupRun*)h;
    if (!r->bridge_queued()) return 0;
    return r->bridge_export_at(0, P, Wt, Lv, tgt, V, E, T, K, S);
}

// feed the CURRENT instance's device results (instances must be fed in
// flattened queue order, matching the export order)
i32 core_bridge_step(void* h, const i32* ostk, const i32* par,
                     const i32* pix, i32 V, i32 T, i32 K, i32 S) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->brq[r->brq_i]->bs->consume_device(ostk, par, pix, V, T, K, S);
    r->bridge_feed_done();
    return r->advance();
}

i32 core_bridge_solve_host(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->brq[r->brq_i]->bs->solve_inst_host();
    r->bridge_feed_done();
    return r->advance();
}

// ---- fused drain (ops/greedy_fused.py): one export + one consume per
//      paused graph; the device runs the whole repeat-until-drained loop.

// f64 adjacency + in-edge-position matrix of the paused graph (topo
// space), or 0 when fused-ineligible (caller falls back per graph)
i32 core_greedy_export_fused(void* h, double* W, i32* P, i32 maxv,
                             i32* sink_pos, double* scal3) {
    core::GroupRun* r = (core::GroupRun*)h;
    if (!r->sc) return 0;
    return r->sc->greedy_export_fused(W, P, maxv, r->device_minv,
                                      sink_pos, scal3);
}

// consume the device's packed paths (+ final host drain check); returns
// the next pause kind.  mode 0 = trust, 1 = verify (see core_scallop.h).
i32 core_greedy_consume_fused(void* h, const double* ws,
                              const uint8_t* paths, i32 npaths, i32 maxv,
                              i32 mode, i64* stats2) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->sc->greedy_consume_fused(ws, paths, npaths, maxv, mode, stats2);
    r->finish_scallop();
    return r->advance();
}

// Standalone native LADDER benchmark (crossover measurement for the
// device scallop ladder, ops/ladder_kernel.py).  Rebuilds each graph +
// hyper node-lists through the normal construction path (add_edge in si
// order, HyperSet::add_node_list + build) and times the genuine host
// ladder_loop.  Flattened batch layout: edges at [eoff[b], eoff[b+1]),
// hyper lists at [hoff[b], hoff[b+1]) with vertices at
// [hvoff[k], hvoff[k+1]).  ndec_out gets each graph's rung-1..4 decision
// count (cross-checked against the device log); nanos_out = {build ns,
// ladder ns}.
void core_bench_ladder(i32 B, const i32* nv, const i32* eoff,
                       const i32* es, const i32* et, const double* ew,
                       const i32* estr, const i32* hoff, const i32* hvoff,
                       const i32* hverts, const i64* hcnts,
                       const i64* cfg_ints, const double* cfg_dbls,
                       i32* ndec_out, i64* nanos_out) {
    using clk = std::chrono::steady_clock;
    core::Cfg cfg = core::cfg_from_arrays(cfg_ints, cfg_dbls);
    std::vector<std::unique_ptr<core::SpliceGraph>> gs;
    std::vector<std::unique_ptr<core::HyperSet>> hss;
    auto t0 = clk::now();
    for (i32 b = 0; b < B; b++) {
        gs.emplace_back(new core::SpliceGraph());
        hss.emplace_back(new core::HyperSet());
        core::SpliceGraph& g = *gs.back();
        for (i32 v = 0; v < nv[b]; v++) g.add_vertex();
        for (i32 i = eoff[b]; i < eoff[b + 1]; i++) {
            core::GEdge* e = g.add_edge(es[i], et[i]);
            e->wrt = ew[i];
            e->info.strand = estr[i];
            // single-sample stamping, as the meta assembler would
            // (matches the Python synth generator in ops/crossover.py)
            e->info.samples.assign(1, 0);
            e->info.spAbd[0] = ew[i];
            e->info.abd = ew[i];
            e->info.count = 1;
        }
        core::HyperSet& hs = *hss.back();
        for (i32 k = hoff[b]; k < hoff[b + 1]; k++) {
            std::vector<int> vv(hverts + hvoff[k], hverts + hvoff[k + 1]);
            hs.add_node_list(vv, hcnts[k]);
        }
    }
    auto t1 = clk::now();
    i64 lad_ns = 0;
    for (i32 b = 0; b < B; b++) {
        core::Scallop sc(*gs[(size_t)b], *hss[(size_t)b], cfg);
        std::vector<std::pair<i32, i32>> log;
        auto u0 = clk::now();
        sc.ladder_prep();
        sc.ladder_loop(&log);
        auto u1 = clk::now();
        lad_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
            u1 - u0).count();
        ndec_out[b] = (i32)log.size();
    }
    nanos_out[0] = std::chrono::duration_cast<std::chrono::nanoseconds>(
        t1 - t0).count();
    nanos_out[1] = lad_ns;
}

// Standalone native drain benchmark for the device-crossover model
// (bench.py crossover_probe / meta/device_wave.py amortized policy).
// Rebuilds each dense [V,V] batch row as the production intrusive-list
// SpliceGraph (edges inserted in P order so the DP's last-wins tie rule
// matches, splice_graph.cc:845-851) and runs the genuine host drain:
// repeat {compute_maximum_path_w; subtract the bottleneck with the
// split_edge arithmetic of scallop.cc:2433-2484} — identical semantics
// to ops/greedy_fused.py drain_host, on the same inputs the device
// dispatch receives.  nanos_out = {graph build ns, drain ns}; ws_out /
// np_out let the caller cross-check parity with the device results.
void core_bench_drain(const double* W, const i32* P, const i32* sink,
                      const double* scal, i32 B, i32 V, i32 maxp,
                      double* ws_out, i32* np_out, i64* nanos_out) {
    using clk = std::chrono::steady_clock;
    std::vector<core::SpliceGraph> graphs((size_t)B);
    std::vector<std::pair<i32, int>> order;
    auto t0 = clk::now();
    for (i32 b = 0; b < B; b++) {
        core::SpliceGraph& g = graphs[(size_t)b];
        if (sink[b] <= 0) continue;
        int n = sink[b] + 1;
        for (int v = 0; v < n; v++) g.add_vertex();
        const double* Wb = W + (size_t)b * V * V;
        const i32* Pb = P + (size_t)b * V * V;
        for (int v = 1; v < n; v++) {
            order.clear();
            for (int u = 0; u < n; u++) {
                i32 p = Pb[(size_t)u * V + v];
                if (p >= 0) order.push_back({p, u});
            }
            std::sort(order.begin(), order.end());
            for (auto& pu : order)
                g.add_edge(pu.second, v)->wrt =
                    Wb[(size_t)pu.second * V + v];
        }
    }
    auto t1 = clk::now();
    for (i32 b = 0; b < B; b++) {
        np_out[b] = 0;
        if (sink[b] <= 0) continue;
        core::SpliceGraph& g = graphs[(size_t)b];
        double mincov = scal[(size_t)b * 3 + 0];
        double guard = scal[(size_t)b * 3 + 1];
        double smin = scal[(size_t)b * 3 + 2];
        std::vector<core::GEdge*> path;
        for (i32 k = 0; k < maxp; k++) {
            double w = g.compute_maximum_path_w(path);
            if (w < 0.0 || w <= mincov) break;
            for (core::GEdge* e : path) {
                double d = e->wrt - w;
                if (std::abs(d) <= smin) g.remove_edge(e);
                else e->wrt = (d <= guard) ? guard : d;
            }
            ws_out[(size_t)b * maxp + k] = w;
            np_out[b]++;
        }
    }
    auto t2 = clk::now();
    nanos_out[0] = std::chrono::duration_cast<std::chrono::nanoseconds>(
        t1 - t0).count();
    nanos_out[1] = std::chrono::duration_cast<std::chrono::nanoseconds>(
        t2 - t1).count();
}

// dense f32 adjacency of the paused graph in topo space, or 0 if the
// graph is device-ineligible (caller then uses core_greedy_solve_host)
i32 core_greedy_export(void* h, float* W, i32 maxv) {
    core::GroupRun* r = (core::GroupRun*)h;
    if (!r->sc) return 0;
    return r->sc->greedy_export(W, maxv, r->device_minv);
}

// one device-guided extraction; returns 1 if still paused, 0 if finished
i32 core_greedy_step(void* h, const float* table) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->sc->greedy_step_device(table);
    if (r->sc->greedy_done) r->finish_scallop();
    return r->advance();
}

// finish the current graph's greedy loop on host; returns like step
i32 core_greedy_solve_host(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    r->sc->greedy_finish_host();
    r->finish_scallop();
    return r->advance();
}

void core_group_sizes(void* h, i64* out3) {
    core::CoreOut& o = ((core::GroupRun*)h)->out;
    out3[0] = (i64)o.g_sid.size();
    out3[1] = (i64)o.t_group.size();
    out3[2] = (i64)o.exons.size();
}

void core_out_fill(void* h, i32* g_sid, i32* g_subindex,
                   i32* t_group, i32* t_pathi, i32* t_strand,
                   i64* t_count1, double* t_cov, double* t_conf,
                   double* t_abd, i32* t_nexons, i64* exons, double* feats);

void core_group_fill(void* h, i32* g_sid, i32* g_subindex,
                     i32* t_group, i32* t_pathi, i32* t_strand,
                     i64* t_count1, double* t_cov, double* t_conf,
                     double* t_abd, i32* t_nexons, i64* exons,
                     double* feats) {
    core_out_fill(&((core::GroupRun*)h)->out, g_sid, g_subindex, t_group,
                  t_pathi, t_strand, t_count1, t_cov, t_conf, t_abd,
                  t_nexons, exons, feats);
}

void core_group_free(void* h) { delete (core::GroupRun*)h; }

void core_out_sizes(void* h, i64* out3) {
    core::CoreOut* o = (core::CoreOut*)h;
    out3[0] = (i64)o->g_sid.size();
    out3[1] = (i64)o->t_group.size();
    out3[2] = (i64)o->exons.size();   // 2 * total exon count
}

void core_out_fill(void* h, i32* g_sid, i32* g_subindex,
                   i32* t_group, i32* t_pathi, i32* t_strand,
                   i64* t_count1, double* t_cov, double* t_conf,
                   double* t_abd, i32* t_nexons, i64* exons, double* feats) {
    core::CoreOut* o = (core::CoreOut*)h;
    auto cp = [](auto& v, auto* dst) {
        if (!v.empty()) memcpy(dst, v.data(), v.size() * sizeof(v[0]));
    };
    cp(o->g_sid, g_sid);
    cp(o->g_subindex, g_subindex);
    cp(o->t_group, t_group);
    cp(o->t_pathi, t_pathi);
    cp(o->t_strand, t_strand);
    cp(o->t_count1, t_count1);
    cp(o->t_cov, t_cov);
    cp(o->t_conf, t_conf);
    cp(o->t_abd, t_abd);
    cp(o->t_nexons, t_nexons);
    cp(o->exons, exons);
    cp(o->feats, feats);
}

void core_out_free(void* h) { delete (core::CoreOut*)h; }

// Cross-sample bundle clustering (meta/bundle_group.py resolve after
// remove_duplicates; meta/bundle_group.cc:26-342): splice index, two
// similarity rounds, greedy best-first union with size cap, group ids.
// splices per bundle are sorted unique int32 (scanner-emitted).  Writes the
// gvv group id per bundle into out_group; returns the group count.
i64 core_cluster_groups(
    i32 n, const i32* const* splices_p, const i64* splice_len,
    double max_junc, double max_sim, double min_sim, i64 max_group_size,
    i32* out_group) {
    using core::i64;
    // disjoint set (bundle_group.py DisjointSet, rank + explicit sizes)
    std::vector<int> parent(n), rank_(n, 0);
    std::vector<i64> size_(n, 1);
    for (i32 i = 0; i < n; i++) parent[i] = i;
    std::function<int(int)> find = [&](int x) {
        int root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int nx = parent[x];
            parent[x] = root;
            x = nx;
        }
        return root;
    };
    auto link = [&](int x, int y) {
        x = find(x);
        y = find(y);
        if (x == y) return x;
        if (rank_[x] < rank_[y]) std::swap(x, y);
        parent[y] = x;
        if (rank_[x] == rank_[y]) rank_[x]++;
        return x;
    };

    // splice position -> bundle set (insertion into std::map = sorted keys;
    // values stay ascending because bundles are visited in index order)
    std::map<int32_t, std::vector<int>> sindex;
    for (i32 k = 0; k < n; k++)
        for (i64 j = 0; j < splice_len[k]; j++)
            sindex[splices_p[k][j]].push_back(k);

    std::vector<bool> grouped(n, false);

    auto isect_count = [&](int a, int b) -> i64 {
        const int32_t* pa = splices_p[a];
        const int32_t* pb = splices_p[b];
        i64 na = splice_len[a], nb = splice_len[b];
        i64 i = 0, j = 0, c = 0;
        while (i < na && j < nb) {
            if (pa[i] < pb[j]) i++;
            else if (pa[i] > pb[j]) j++;
            else { c++; i++; j++; }
        }
        return c;
    };

    auto process_subset = [&](const std::vector<int>& s, double thr) {
        std::vector<int> ss;
        for (int z : s) {                      // ascending (sorted(s))
            if (grouped[z]) continue;
            if (size_[find(z)] >= max_group_size) {
                grouped[z] = true;
                continue;
            }
            ss.push_back(z);
        }
        std::vector<int> cand;
        for (int i : ss)
            if ((double)splice_len[i] / 2.0 <= max_junc) cand.push_back(i);
        // pairs in (i, j) candidate order, exactly like the incidence-matrix
        // kernel's row-major nonzero scan (ops/similarity.py)
        struct P { int x, y; double r; };
        std::vector<P> vpid;
        for (size_t a = 0; a < cand.size(); a++) {
            for (size_t b = a + 1; b < cand.size(); b++) {
                int i = cand[a], j = cand[b];
                i64 mn = std::min(splice_len[i], splice_len[j]);
                if (mn <= 0) continue;
                i64 c = isect_count(i, j);
                if (!((double)c > 0.50)) continue;
                double r = (double)c / (double)mn;
                if (r < thr) continue;
                if (find(i) == find(j)) continue;
                vpid.push_back(P{i, j, r});
            }
        }
        std::stable_sort(vpid.begin(), vpid.end(),
                         [](const P& a, const P& b) { return a.r > b.r; });
        // greedy best-first union with size cap (bundle_group.cc:296-318)
        for (const P& p : vpid) {
            int px = find(p.x), py = find(p.y);
            if (px == py) continue;
            i64 sx = size_[px], sy = size_[py];
            if (sx >= max_group_size || sy >= max_group_size) continue;
            int q = link(px, py);
            size_[find(q)] = sx + sy;
        }
    };

    for (const auto& kv : sindex)
        if (kv.second.size() > 1) process_subset(kv.second, max_sim);
    for (const auto& kv : sindex)
        if (kv.second.size() > 1) process_subset(kv.second, min_sim);

    // group ids in first-root-seen order (bundle_group.cc:320-342)
    std::map<int, i32> mm;
    i32 ng = 0;
    for (i32 i = 0; i < n; i++) {
        int p = find(i);
        auto it = mm.find(p);
        if (it == mm.end()) {
            mm[p] = ng;
            out_group[i] = ng;
            ng++;
        } else {
            out_group[i] = it->second;
        }
    }
    return ng;
}

// Quirks-mode previewer coverage (ALETSCH_REF_QUIRKS): the reference's
// previewer never flushes the bundle interval buffer -- add_buf_intervals
// (bundle_base.cc:160-174) is only called by the generator
// (meta/generator.cc:208), and bundle_base::clear() leaves interval_buf /
// interval_cnt untouched -- so each preview bundle's mmap is missing its
// per-slot TAIL runs and inherits the PREVIOUS bundle's leftovers
// (flushed into the current mmap on slot mismatch, add_intervals
// bundle_base.cc:106-158).  q = 10 slots x (s, p, cnt), persistent per
// stream across the whole preview scan (caller-owned, -1 initialized).
// mm == nullptr advances the buffer without recording (bundles process()
// would skip still mutate the buffer in the reference).
static void quirk_preview_buffer(const i32* fixed, i64 nh,
                                 const i32* coords, i32* q,
                                 core::CoverageMap* mm) {
    for (i64 j = 0; j < nh; j++) {
        const i32* row = fixed + 25 * j;
        i64 off = row[17];
        i64 m = row[18];
        for (i64 z = 0; z < m; z++) {
            i32 s = coords[off + 2 * z];
            i32 p = coords[off + 2 * z + 1];
            if (z >= 10) {                   // INTERVAL_BUF_SIZE
                if (mm) mm->add(s, p, 1);
                continue;
            }
            i32* qs = q + 3 * z;
            if (qs[0] == s && qs[1] == p) {
                qs[2]++;
                continue;
            }
            if (qs[0] != -1 && qs[1] != -1 && qs[2] > 0 && mm)
                mm->add(qs[0], qs[1], qs[2]);
            qs[0] = s;
            qs[1] = p;
            qs[2] = 1;
        }
    }
}

// previewer._process (meta/previewer.py:392-423, previewer.cc:252-305):
// one preview bundle -> up to 1000 fragment inner distances.  Returns the
// number of distances written to out_d (== the processed-cluster count).
// qbuf != NULL replicates the reference's unflushed-buffer coverage.
i64 core_preview_bundle(
    i32 nh, const i32* fixed, const i32* coords,
    const i32* mev, i64 mev_cnt, const i32* iev, i64 iev_cnt,
    const i32* frgs, i64 frg_cnt,
    i64 lpos, i64 rpos, i32 strand,
    const i64* cfg_ints, const double* cfg_dbls,
    i64* out_d, i32* qbuf) {
    core::Bundle bd;
    bd.cfg = core::cfg_from_arrays(cfg_ints, cfg_dbls);
    bd.strand = (char)strand;
    bd.tid = 0;
    bd.lpos = lpos;
    bd.rpos = rpos;
    bd.init_from_scan(fixed, nh, coords, mev, mev_cnt, iev, iev_cnt,
                      frgs, frg_cnt);
    if (qbuf != nullptr) {
        bd.mmap.clear();
        quirk_preview_buffer(fixed, nh, coords, qbuf, &bd.mmap);
    }
    core::SpliceGraph gr;
    core::GraphBuilder(bd, bd.cfg).build(gr);
    gr.build_vertex_index();
    std::vector<core::PereadsCluster> vc;
    core::build_pereads_clusters(gr, bd, 2, vc);
    i64 cnt = 0;
    std::vector<i64> merged;
    for (const auto& pc : vc) {
        i64 p1 = pc.extend[1], p2 = pc.extend[2];
        int k1 = gr.locate_rbound(p1);
        int k2 = gr.locate_lbound(p2);
        if (k1 < 0 || k2 < 0 || k1 < k2) continue;
        if (!core::merge_intron_chains(pc.chain1, pc.chain2, merged))
            continue;
        i64 length = core::get_total_length_of_introns(merged);
        i64 d = pc.bounds[3] - pc.bounds[0] - length;
        out_d[cnt++] = d;
        if (cnt >= 1000) return cnt;
    }
    return cnt;
}

// Chunk-batched previewer: one call per scanner chunk instead of one call
// per bundle (the per-bundle ctypes crossing dominated profile-samples).
// meta is the scanner's nb x 12 chunk layout (io/bam_native.py:300-315:
// [0]=strand flag, [1]=tid, [2]=lpos, [3]=rpos, [4]=#rows, [5]=qname bytes,
// [6]=coords len, [7]=mev len, [8]=iev len, [9]=epoch, [10]=frgs len,
// [11]=splices len); fixed/coords/mev/iev/frgs are the pooled chunk buffers.
// For each bundle with min_hits <= n <= 20000 and tid >= 0 the previewer
// inner loop (core_preview_bundle) runs; out_cnt[b] receives its distance
// count and the distances append to out_d in bundle order.  Python applies
// the max_preview_reads/epoch cap on the returned per-bundle counts
// (meta/previewer.py:218-235 semantics unchanged).
i64 core_preview_chunk(
    i32 nb, const i64* meta,
    const i32* fixed, const i32* coords,
    const i32* mev, const i32* iev, const i32* frgs,
    i64 min_hits,
    const i64* cfg_ints, const double* cfg_dbls,
    i64* out_d, i64* out_cnt, i32* qbufs) {
    i64 ro = 0, co = 0, mo = 0, io = 0, fo = 0;
    i64 total = 0;
    for (i32 b = 0; b < nb; b++) {
        const i64* m = meta + (size_t)b * 14;
        i64 n = m[4];
        i64 cl = m[6], ml = m[7], il = m[8], fl = m[10];
        // per-stream persistent buffer (quirks mode); the reference's
        // buffer advances for EVERY bundle, including ones process()
        // skips
        i32* qb = qbufs == nullptr ? nullptr : qbufs + 30 * (m[0] & 1);
        if (n >= min_hits && n <= 20000 && m[1] >= 0) {
            i32 strand = fixed[ro * 25 + 22];
            out_cnt[b] = core_preview_bundle(
                (i32)n, fixed + ro * 25, coords + co,
                mev + mo, ml / 2, iev + io, il / 2,
                frgs + fo, fl / 2,
                m[2], m[3], strand,
                cfg_ints, cfg_dbls, out_d + total, qb);
            total += out_cnt[b];
        } else {
            out_cnt[b] = 0;
            if (qb != nullptr)
                quirk_preview_buffer(fixed + ro * 25, n, coords + co, qb,
                                     nullptr);
        }
        ro += n; co += cl; mo += ml; io += il; fo += fl;
    }
    return total;
}

// ---- debug: FNV-1a over a GroupRun's mutable assembly state.  Used to
//      bisect platform-divergence bugs (found round 3's non-contiguous
//      relay-view corruption); kept behind the C ABI for future triage.
static void dbg_mix(uint64_t& x, const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    for (size_t i = 0; i < n; i++) { x ^= b[i]; x *= 1099511628211ULL; }
}
static void dbg_chainset(uint64_t& x, const core::ChainSet& cs) {
    for (const auto& g : cs.chains)
        for (const auto& it : g) {
            dbg_mix(x, it.v.data(), it.v.size() * sizeof(i64));
            dbg_mix(x, it.c, sizeof(it.c));
        }
}
static void dbg_graph(uint64_t& x, const core::SpliceGraph& gr) {
    int n = (int)gr.vinfo.size();
    dbg_mix(x, &n, sizeof(n));
    for (int v = 0; v < n; v++) {
        dbg_mix(x, &gr.vinfo[v].lpos, sizeof(i64));
        dbg_mix(x, &gr.vinfo[v].rpos, sizeof(i64));
        dbg_mix(x, &gr.vwrt[v], sizeof(double));
        for (core::GEdge* e = gr.vout[v].head; e; e = e->onext) {
            dbg_mix(x, &e->s, sizeof(int));
            dbg_mix(x, &e->t, sizeof(int));
            dbg_mix(x, &e->wrt, sizeof(double));
        }
    }
}
static void dbg_bundle(uint64_t& x, const core::Bundle& bd) {
    dbg_mix(x, &bd.tid, sizeof(bd.tid));
    dbg_mix(x, &bd.lpos, sizeof(bd.lpos));
    dbg_mix(x, &bd.rpos, sizeof(bd.rpos));
    dbg_mix(x, &bd.strand, 1);
    for (const auto& f : bd.frgs) dbg_mix(x, f.data(), 3 * sizeof(i64));
    dbg_chainset(x, bd.hcst);
    dbg_chainset(x, bd.fcst);
    dbg_mix(x, bd.mmap.events.data(), bd.mmap.events.size() * sizeof(i64));
}
static void dbg_bpath(uint64_t& x, const core::BridgePath& p) {
    dbg_mix(x, &p.type, sizeof(p.type));
    dbg_mix(x, &p.score, sizeof(p.score));
    dbg_mix(x, p.stack.data(), p.stack.size() * sizeof(i64));
    dbg_mix(x, p.v.data(), p.v.size() * sizeof(int));
    dbg_mix(x, p.chain.data(), p.chain.size() * sizeof(i64));
    dbg_mix(x, p.whole.data(), p.whole.size() * sizeof(i64));
    dbg_mix(x, &p.strand, sizeof(p.strand));
    dbg_mix(x, &p.choices, sizeof(p.choices));
}
i64 core_debug_hash2(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    uint64_t x = 1469598103934665603ULL;
    for (auto& enp : r->brq) {
        core::GroupRun::BridgeEntry& en = *enp;
        if (!en.bs) continue;
        core::BridgeSolver& bs = *en.bs;
        i64 ii = (i64)bs.inst_i, ni = (i64)bs.insts.size();
        dbg_mix(x, &ii, sizeof(ii));
        dbg_mix(x, &ni, sizeof(ni));
        for (auto& in : bs.insts) dbg_mix(x, &in, sizeof(in));
        for (auto& pr : bs.piers) {
            dbg_mix(x, &pr.bs, sizeof(pr.bs));
            dbg_mix(x, &pr.bt, sizeof(pr.bt));
            for (auto& p : pr.bridges) dbg_bpath(x, p);
        }
        for (auto& p : bs.opt) dbg_bpath(x, p);
    }
    i64 bi = (i64)r->brq_i;
    dbg_mix(x, &bi, sizeof(bi));
    return (i64)x;
}
i64 core_debug_hash(void* h) {
    core::GroupRun* r = (core::GroupRun*)h;
    uint64_t x = 1469598103934665603ULL;
    for (auto& bp : r->bundles) dbg_bundle(x, *bp);
    dbg_bundle(x, r->bx);
    dbg_graph(x, r->gx);
    for (auto& gp : r->grv) dbg_graph(x, *gp);
    if (r->br_cb) dbg_bundle(x, *r->br_cb);
    if (r->br_gx) dbg_graph(x, *r->br_gx);
    if (r->sc_gr) dbg_graph(x, *r->sc_gr);
    dbg_mix(x, &r->phase, sizeof(r->phase));
    dbg_mix(x, &r->bphase, sizeof(r->bphase));
    return (i64)x;
}

}  // extern "C"

// ---- native transcript-set merge + writers (core_tset.h; replaces the
//      Python replay / fold / output formatting of meta/native_core.py
//      _replay_transcripts + core/transcript_set.py + incubator
//      postprocess — the Python path stays as the byte-exact oracle).

// replay of one CoreOut into a target set, mirroring
// meta/native_core.py::_replay_transcripts exactly: per-graph set built in
// transcript order, then folded (assembler.cc:1121-1136 order)
static void tset_merge_out(core::CoreOut& o, core_tset::NTSet* tgt,
                           i64 rid, i64 gid, i64 inst, const char* chrm,
                           i32 skip_se) {
    using namespace core_tset;
    size_t ng = o.g_sid.size(), nt = o.t_group.size();
    if (ng == 0) return;
    std::vector<size_t> eo(nt);
    size_t acc = 0;
    for (size_t i = 0; i < nt; i++) {
        eo[i] = acc;
        acc += 2 * (size_t)o.t_nexons[i];
    }
    std::vector<std::vector<i32>> per(ng);
    for (size_t i = 0; i < nt; i++)
        per[o.t_group[i]].push_back((i32)i);
    char gidbuf[128], tidbuf[320];
    for (size_t g = 0; g < ng; g++) {
        NTSet ts;
        ts.seo = tgt->seo;
        int sid = o.g_sid[g];
        snprintf(gidbuf, sizeof(gidbuf), "instance.%lld.%lld.%lld.%d.0",
                 (long long)rid, (long long)gid, (long long)inst,
                 (int)o.g_subindex[g]);
        for (i32 i : per[g]) {
            i32 ne = o.t_nexons[i];
            if (ne <= 1 && skip_se) continue;
            NItem it;
            NTrans& t = it.trst;
            t.gene_id = gidbuf;
            snprintf(tidbuf, sizeof(tidbuf), "chr%s.%s.%d", chrm, gidbuf,
                     (int)o.t_pathi[i]);
            t.tid = tidbuf;
            t.meta_tid = tidbuf;
            t.strand = (char)o.t_strand[i];
            t.coverage = t.cov2 = o.t_cov[i];
            t.conf = o.t_conf[i];
            t.abd = o.t_abd[i];
            t.count1 = o.t_count1[i];
            t.count2 = 1;
            t.exons.assign(o.exons.begin() + eo[i],
                           o.exons.begin() + eo[i] + 2 * (size_t)ne);
            t.feat.assign(
                o.feats.begin() + (size_t)i * core::N_FEATURES,
                o.feats.begin() + (size_t)(i + 1) * core::N_FEATURES);
            it.count = 1;
            NTrans copy = t;          // TransItem clone, count2 = 1
            it.samples.emplace_back(sid, std::move(copy));
            uint64_t key = chain_hash(t.exons);
            set_insert_item(&ts, key, std::move(it));
        }
        set_add(tgt, &ts);
    }
}

extern "C" {

// per-rung resolution-ladder fire counters (core::Scallop::ladder_hist;
// scallop.cc:47-173 rung order).  reset != 0 zeroes after reading.
void core_ladder_hist(i64* out11, i32 reset) {
    std::atomic<long long>* h = core::Scallop::ladder_hist();
    for (int i = 0; i < 11; i++) {
        out11[i] = (i64)h[i].load();
        if (reset) h[i].store(0);
    }
}

void* nts_new(double single_exon_overlap) {
    core_tset::NTSet* s = new core_tset::NTSet();
    s->seo = single_exon_overlap;
    return s;
}

void nts_free(void* h) { delete (core_tset::NTSet*)h; }

// ---- deferred free: destroying a large NTSet walks thousands of small
// heap blocks (~77 us each measured on the production soak main thread).
// nts_free_async hands the handle to a detached drainer thread so the
// destruction overlaps assembly/replay work.  Ownership transfers wholly
// at enqueue; glibc malloc is thread-safe, and the drainer is never
// joined (process exit reclaims everything it might still hold).
namespace {
// intentionally leaked: a static condition_variable's destructor at
// process exit blocks while the detached drainer waits on it
// (pthread_cond_destroy waits for waiters) — heap-allocated sync objects
// are never destroyed, so exit proceeds and exit_group reaps the thread
struct FreeQueue {
    std::mutex mu;
    std::condition_variable cv;
    std::vector<void*> q;
    bool started = false;
};
FreeQueue* free_queue() {
    static FreeQueue* fq = new FreeQueue();
    return fq;
}
}  // namespace

void nts_free_async(void* h) {
    if (h == nullptr) return;
    FreeQueue* fq = free_queue();
    std::unique_lock<std::mutex> lk(fq->mu);
    if (!fq->started) {
        fq->started = true;
        std::thread([fq]() {
            std::vector<void*> batch;
            for (;;) {
                {
                    std::unique_lock<std::mutex> lk2(fq->mu);
                    fq->cv.wait(lk2, [fq] { return !fq->q.empty(); });
                    batch.swap(fq->q);
                }
                for (void* p : batch) delete (core_tset::NTSet*)p;
                batch.clear();
            }
        }).detach();
    }
    fq->q.push_back(h);
    fq->cv.notify_one();
}

void nts_add(void* dst, void* src) {
    core_tset::set_add((core_tset::NTSet*)dst, (core_tset::NTSet*)src);
}

void nts_sync(void* h) { core_tset::set_sync((core_tset::NTSet*)h); }

i64 nts_size(void* h) {
    core_tset::NTSet* s = (core_tset::NTSet*)h;
    i64 n = 0;
    for (auto& kv : s->mt) n += (i64)kv.second.size();
    return n;
}

void core_out_merge_nts(void* outh, void* tgt, i64 rid, i64 gid, i64 inst,
                        const char* chrm, i32 skip_se) {
    tset_merge_out(*(core::CoreOut*)outh, (core_tset::NTSet*)tgt, rid, gid,
                   inst, chrm, skip_se);
}

void core_group_merge_nts(void* h, void* tgt, i64 rid, i64 gid, i64 inst,
                          const char* chrm, i32 skip_se) {
    tset_merge_out(((core::GroupRun*)h)->out, (core_tset::NTSet*)tgt, rid,
                   gid, inst, chrm, skip_se);
}

void core_batch_merge_nts(void* bh, i32 n_groups, void** tgt,
                          const i64* rid, const i64* gid, const i64* inst,
                          const char* chrm, const i32* skip_se) {
    BatchOut* bo = (BatchOut*)bh;
    for (i32 g = 0; g < n_groups; g++)
        tset_merge_out(bo->outs[g], (core_tset::NTSet*)tgt[g], rid[g],
                       gid[g], inst[g], chrm, skip_se[g]);
}

void BatchJob::run_merge() {
    for (i32 g = 0; g < n_groups; g++)
        tset_merge_out(bo->outs[g], (core_tset::NTSet*)m_tgt[g], m_rid[g],
                       m_gid[g], m_inst[g], m_chrm.c_str(), m_skip[g]);
}

// async batch + in-worker native-set replay: same as
// core_resolve_groups_mt_async but the wave's transcript merges run on
// the worker that finishes the last group (in group order, identical
// bytes) — core_batch_join returns with the replay already done.
void* core_resolve_groups_mt_async_merge(
    i32 n_groups, i32 nthreads, i32 do_bridge,
    const i32* grp_nb,
    const i32* nh,
    const i32* const* fixed_p,
    const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand,
    const i64* lpos, const i64* rpos,
    const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls,
    void** tgt, const i64* rid, const i64* gid, const i64* inst,
    const char* chrm, const i32* skip_se) {
    BatchJob* job = make_batch_job(
        n_groups, do_bridge, grp_nb, nh, fixed_p, coords_p, mev_p, mev_cnt,
        iev_p, iev_cnt, frg_p, frg_cnt, sample_id, strand, lpos, rpos,
        ins_low, ins_high, cfg_ints, cfg_dbls);
    job->m_merge = true;
    job->m_tgt.assign(tgt, tgt + n_groups);
    job->m_rid.assign(rid, rid + n_groups);
    job->m_gid.assign(gid, gid + n_groups);
    job->m_inst.assign(inst, inst + n_groups);
    job->m_skip.assign(skip_se, skip_se + n_groups);
    job->m_chrm = chrm;
    batch_job_spawn(job, nthreads, false);
    return job;
}

// import a Python-built TranscriptSet (fallback-assembled groups,
// meta/native_tset.py _import): bucket-grouped item records, each root
// followed by its insertion-ordered sample copies
void nts_import_merge(void* tgt_, i64 n_buckets, const uint64_t* bkeys,
                      const i32* bcounts, const i64* icounts,
                      const i32* ncopies, const i32* r_sid,
                      const i32* r_strand, const double* r_cov,
                      const double* r_cov2, const double* r_conf,
                      const double* r_abd, const i64* r_count1,
                      const i32* r_count2, const i32* r_nexons,
                      const i64* exons_flat, const double* feats_flat,
                      const i64* str_off, const char* strbuf) {
    using namespace core_tset;
    NTSet* tgt = (NTSet*)tgt_;
    NTSet src;
    src.seo = tgt->seo;
    size_t item = 0, rec = 0, eoff = 0;
    auto load_rec = [&](NTrans& t) {
        t.strand = (char)r_strand[rec];
        t.coverage = r_cov[rec];
        t.cov2 = r_cov2[rec];
        t.conf = r_conf[rec];
        t.abd = r_abd[rec];
        t.count1 = r_count1[rec];
        t.count2 = r_count2[rec];
        i32 ne = r_nexons[rec];
        t.exons.assign(exons_flat + eoff, exons_flat + eoff + 2 * (size_t)ne);
        eoff += 2 * (size_t)ne;
        t.feat.assign(feats_flat + rec * core::N_FEATURES,
                      feats_flat + (rec + 1) * core::N_FEATURES);
        t.gene_id = strbuf + str_off[3 * rec + 0];
        t.tid = strbuf + str_off[3 * rec + 1];
        t.meta_tid = strbuf + str_off[3 * rec + 2];
        rec++;
    };
    for (i64 b = 0; b < n_buckets; b++) {
        std::vector<NItem> bucket;
        bucket.reserve((size_t)bcounts[b]);
        for (i32 j = 0; j < bcounts[b]; j++, item++) {
            NItem it;
            it.count = icounts[item];
            i32 nc = ncopies[item];
            load_rec(it.trst);            // root record (r_sid unused)
            for (i32 c = 0; c < nc; c++) {
                i32 sid = r_sid[rec];
                NTrans cp;
                load_rec(cp);
                it.samples.emplace_back(sid, std::move(cp));
            }
            bucket.push_back(std::move(it));
        }
        src.mt.emplace(bkeys[b], std::move(bucket));
    }
    set_add(tgt, &src);
}

// combined GTF (meta/incubator.py write_combined_gtf,
// incubator.cc:713-743): sets in the caller's sorted (chrm, strand)
// order, buckets by sorted key, items in list order
i32 nts_write_combined(void** hs, i32 n, const char* const* chrms,
                       const char* path, const char* source) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    std::vector<char> buf(1 << 20);
    setvbuf(f, buf.data(), _IOFBF, buf.size());
    for (i32 i = 0; i < n; i++) {
        core_tset::NTSet* s = (core_tset::NTSet*)hs[i];
        for (uint64_t k : core_tset::sorted_keys(s))
            for (core_tset::NItem& z : s->mt.at(k))
                core_tset::write_gtf_rec(f, z.trst, chrms[i], source, -1.0,
                                         (i64)z.samples.size());
    }
    fclose(f);
    return 0;
}

// per-sample GTFs + feature CSVs (meta/incubator.py
// write_individual_gtfs, incubator.cc:745-796) in one pass over the sets;
// samples partitioned across threads like the reference's parallel
// postprocess (incubator.cc:673-711)
i32 nts_write_individual(void** hs, i32 n_sets, const char* const* chrms,
                         const char* dir, i32 n_samples, double min_se,
                         const char* source, i32 nthreads) {
    using namespace core_tset;
    std::vector<std::vector<uint64_t>> keys((size_t)n_sets);
    for (i32 i = 0; i < n_sets; i++)
        keys[i] = sorted_keys((NTSet*)hs[i]);
    std::atomic<int> fail{0};
    auto work = [&](i32 lo, i32 hi) {
        size_t nf = (size_t)(hi - lo);
        std::vector<FILE*> fg(nf, nullptr), ff(nf, nullptr);
        char pathbuf[4096];
        for (i32 j = lo; j < hi; j++) {
            snprintf(pathbuf, sizeof(pathbuf), "%s/%d.gtf", dir, (int)j);
            fg[j - lo] = fopen(pathbuf, "w");
            snprintf(pathbuf, sizeof(pathbuf), "%s/%d.trstFeature.csv",
                     dir, (int)j);
            ff[j - lo] = fopen(pathbuf, "w");
            if (!fg[j - lo] || !ff[j - lo]) fail.store(1);
        }
        if (!fail.load()) {
            for (i32 i = 0; i < n_sets; i++) {
                NTSet* s = (NTSet*)hs[i];
                const char* chrm = chrms[i];
                for (uint64_t k : keys[i])
                    for (NItem& z : s->mt.at(k))
                        for (auto& p : z.samples) {
                            i32 j = p.first;
                            if (j == -1) j = n_samples - 1;
                            if (j < lo || j >= hi) continue;
                            NTrans& t = p.second;
                            if (t.nex() == 1) {
                                if (t.cov2 < min_se) continue;
                                write_gtf_rec(fg[j - lo], t, chrm, source,
                                              t.cov2, t.count2);
                            } else {
                                write_gtf_rec(fg[j - lo], t, chrm, source,
                                              t.cov2, t.count2);
                                write_feat_row(ff[j - lo], t, chrm);
                            }
                        }
            }
        }
        for (FILE* fp : fg)
            if (fp) fclose(fp);
        for (FILE* fp : ff)
            if (fp) fclose(fp);
    };
    i32 T = nthreads < 1 ? 1 : nthreads;
    if (T > n_samples) T = n_samples > 0 ? n_samples : 1;
    if (T <= 1 || n_samples <= 1) {
        work(0, n_samples);
    } else {
        std::vector<std::thread> ths;
        i32 per = (n_samples + T - 1) / T;
        for (i32 t0 = 0; t0 < n_samples; t0 += per) {
            i32 t1 = t0 + per < n_samples ? t0 + per : n_samples;
            ths.emplace_back(work, t0, t1);
        }
        for (auto& t : ths) t.join();
    }
    return fail.load() ? -1 : 0;
}

}  // extern "C"
