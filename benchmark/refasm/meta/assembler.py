"""Group assembly: combined graphs, cross-sample support, decomposition.

Re-implements meta/assembler.{h,cc}: per-bundle fragment building and
bridging; for multi-bundle groups a joint re-bridging pass against the
combined graph (assembler.cc:977-1018), construction of the combined bundle
and graph, cross-sample junction-support stamping, pairwise start/end and
non-splicing support, boundary-extend features, and finally per-graph
assembly (extend strands -> group boundaries -> hyper set -> scallop ->
transcript set, assembler.cc:1075-1136).
"""

from __future__ import annotations

from ..bridge.solver import BridgeSolver
from ..constants import TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
from ..core.chain_set import PhaseSet
from ..core.graph import SpliceGraph
from ..core.graph_builder import GraphBuilder, refine_splice_graph
from ..core.graph_cluster import build_pereads_clusters
from ..core.graph_reviser import (group_end_boundaries,
                                  group_start_boundaries,
                                  identify_boundaries,
                                  remove_false_boundaries)
from ..scallop.decompose import Scallop
from ..scallop.hyper_set import HyperSet
from .bundle import Bundle
from .transcript_store import new_transcript_set


def _pack(a, b):
    return (a << 32) | (b & 0xFFFFFFFF)


class Assembler:
    def __init__(self, cfg, tmerge, rid, gid, instance):
        self.cfg = cfg
        self.tmerge = tmerge
        self.rid = rid
        self.gid = gid
        self.instance = instance

    # ------------------------------------------------------------- entrypoint
    def resolve(self, gv):
        """assembler.cc:33-73; dispatches whole groups of pristine scanner
        bundles to the native core (native/core.cpp), which runs this entire
        method (bridge -> joint bridge -> supports -> scallop) bit-exactly."""
        from .native_core import resolve_group_native
        if resolve_group_native(self, gv, do_bridge=True):
            return
        self.resolve_fallback(gv)

    def resolve_fallback(self, gv):
        """The Python oracle path (assembler.cc:33-73 body), also entered
        directly by the incubator's pipelined group loop when a group is
        ineligible for the native core."""
        for bd in gv:
            bd.build_fragments()
            bd.bridge()
        if len(gv) == 1:
            self.assemble_single(gv[0])
        elif len(gv) >= 2:
            self.joint_bridge(gv)
            self.assemble_group(gv)

    # ------------------------------------------------------- single bundles
    def transform(self, bd, revising):
        """assembler.cc:930-944"""
        gr = SpliceGraph()
        GraphBuilder(bd, self.cfg).build(gr)
        gr.gid = bd.gid
        gr.build_vertex_index()
        if revising:
            identify_boundaries(gr, self.cfg)
            remove_false_boundaries(gr, bd, self.cfg)
            refine_splice_graph(gr)
        return gr

    def _stamp_own_sample(self, gr, sid):
        """assembler.cc:117-138 / 255-282"""
        for e in gr.edges():
            ei = gr.get_edge_info(e)
            ei.samples = {sid}
            ei.spAbd = {sid: gr.get_edge_weight(e)}
            ei.abd = gr.get_edge_weight(e)
            ei.count = 1

    def assemble_single(self, bd):
        """assembler.cc:107-150"""
        bd.set_gid(self.rid, self.gid, self.instance, 0)
        gr = self.transform(bd, True)
        gr.reads = len(bd.frgs)
        gr.subgraph = 1
        self._stamp_own_sample(gr, bd.sp.sample_id)
        ps = PhaseSet()
        bd.build_phase_set(ps, gr)
        self.assemble_graph(gr, ps, bd.sp.sample_id)
        bd.clear()

    # ------------------------------------------------------- joint bridging
    def joint_bridge(self, gv):
        """Re-bridge each bundle against the combined graph
        (assembler.cc:977-1018)."""
        cb = Bundle(self.cfg, gv[0].sp)
        cb.copy_meta_information(gv[0])
        self.combine_bundles(cb, gv)
        gr = self.transform(cb, False)
        for bd in gv:
            vc = build_pereads_clusters(gr, bd, self.cfg.max_reads_partition_gap)
            if len(vc) <= 0:
                continue
            bs = BridgeSolver(gr, vc, self.cfg, bd.sp.insertsize_low,
                              bd.sp.insertsize_high)
            for j, pc in enumerate(vc):
                if bs.opt[j].type <= 0:
                    continue
                bd.update_bridges(pc.frlist, bs.opt[j].chain, bs.opt[j].strand)
        cb.clear()

    def combine_bundles(self, bx, gv):
        """Largest-coverage-first combining (assembler.cc:152-175)."""
        order = sorted(range(len(gv)),
                       key=lambda k: -len(gv[k].mmap.segments[0]))
        for k in order:
            bx.combine(gv[k], True)

    # ------------------------------------------------------- group assembly
    def assemble_group(self, gv):
        """assembler.cc:177-373"""
        subindex = 0
        bx = Bundle(self.cfg, gv[0].sp)
        bx.copy_meta_information(gv[0])
        self.combine_bundles(bx, gv)
        bx.set_gid(self.rid, self.gid, self.instance, subindex)
        subindex += 1
        gx = self.transform(bx, False)
        gx.reads = len(bx.frgs)
        gx.subgraph = len(gv)

        junc2sup = {}
        sup2abd = {}

        def _collect_support(gr, sid):
            for e in gr.edges():
                s, t = e.s, e.t
                ei = gr.get_edge_info(e)
                ei.samples = {sid}
                ei.spAbd = {sid: gr.get_edge_weight(e)}
                ei.abd = gr.get_edge_weight(e)
                ei.count = 1
                if s == 0 or t == gr.num_vertices() - 1:
                    continue
                p0 = (gr.get_vertex_info(s).rpos, gr.get_vertex_info(t).lpos)
                if p0[0] == p0[1]:
                    continue
                p = _pack(p0[0], p0[1])
                junc2sup.setdefault(p, set()).add(sid)
                sup2abd.setdefault(p, {})[sid] = gr.get_edge_weight(e)

        _collect_support(gx, -1)

        grv = []
        idv = []
        for bd in gv:
            bd.set_gid(self.rid, self.gid, self.instance, subindex)
            subindex += 1
            gr = self.transform(bd, True)
            gr.reads = len(bd.frgs)
            gr.subgraph = len(gv)
            _collect_support(gr, bd.sp.sample_id)
            grv.append(gr)
            idv.append(bd.sp.sample_id)

        px = PhaseSet()
        for k, bd in enumerate(gv):
            gr = grv[k]
            if self.cfg.verbose >= 2:
                self.fix_missing_edges(gr, gx)
            self.junction_support(gr, junc2sup, sup2abd)
            for j in range(len(gv)):
                gr1 = grv[j]
                self.start_end_support(gv[j].sp.sample_id, gr1, gr)
                self.non_splicing_support(gv[j].sp.sample_id, gr1, gr)
                self.boundary_extend(gv[j].sp.sample_id, gr, gr1, 1)
                self.boundary_extend(gv[j].sp.sample_id, gr, gr1, 2)
                self.boundary_extend(gv[j].sp.sample_id, gr, gr1, 3)
            ps = PhaseSet()
            bd.build_phase_set(ps, gr)
            px.combine(ps)
            self.start_end_support(bd.sp.sample_id, gr, gx)
            self.non_splicing_support(bd.sp.sample_id, gr, gx)
            self.boundary_extend(-1, gr, gx, 1)
            self.assemble_graph(gr, ps, bd.sp.sample_id)
            bd.clear()
        bx.clear()
        self.junction_support(gx, junc2sup, sup2abd)
        self.assemble_graph(gx, px, -1)

    # ------------------------------------------------------ support features
    def fix_missing_edges(self, gr, gx):
        """Diagnostic only (meta/assembler.cc:946-975): report starting
        boundaries of gr that the combined graph gx explains via a missing
        edge; the reference computes and prints at verbose >= 2 without
        mutating either graph."""
        for e in list(gr.out_edges(0)):
            t = e.t
            vt = gr.get_vertex_info(t)
            wt = gr.get_vertex_weight(t)
            v = gx.locate_rbound(vt.rpos)
            if v == -1:
                continue
            if gx.in_degree(v) != 1:
                continue
            vv = gx.get_vertex_info(v)
            uv = next(iter(gx.in_edges(v)))
            u = uv.s
            wuv = gx.get_edge_weight(uv)
            if u == 0:
                continue
            vu = gx.get_vertex_info(u)
            if vu.rpos == vv.lpos:
                continue
            if gr.locate_rbound(vu.rpos) == -1:
                continue
            gap = vt.lpos - vv.lpos
            print("fixing starting boundary t = %d-%d using u = %d-%d, "
                  "v = %d-%d, gap = %d, wt = %.1f, wuv = %.1f"
                  % (vt.lpos, vt.rpos, vu.lpos, vu.rpos, vv.lpos, vv.rpos,
                     gap, wt, wuv))

    def junction_support(self, gr, junc2sup, sup2abd):
        """Stamp every splicing edge with its cross-sample support set
        (assembler.cc:375-417)."""
        for e in gr.edges():
            s, t = e.s, e.t
            if s == 0 or t == gr.num_vertices() - 1:
                continue
            if gr.get_vertex_info(s).rpos == gr.get_vertex_info(t).lpos:
                continue
            p = _pack(gr.get_vertex_info(s).rpos, gr.get_vertex_info(t).lpos)
            if p not in junc2sup:
                continue
            ei = gr.get_edge_info(e)
            ei.samples = set(junc2sup[p])
            ei.spAbd = dict(sup2abd[p])
            ei.count = len(ei.samples)
            # sum in sorted-sample order (canonical float-sum order)
            ei.abd += sum(sup2abd[p][k] for k in sorted(sup2abd[p]))

    def non_splicing_support(self, sample_id, gr, gx):
        """assembler.cc:419-462"""
        n = gx.num_vertices() - 1
        for e in gx.edges():
            s, t = e.s, e.t
            if s == 0 or t == n:
                continue
            ei = gx.get_edge_info(e)
            if gx.get_vertex_info(s).rpos != gx.get_vertex_info(t).lpos:
                continue
            p = gx.get_vertex_info(t).lpos
            k1 = gr.locate_vertex(p - 1)
            k2 = gr.locate_vertex(p)
            if k1 < 0 or k2 < 0:
                continue
            if k1 == k2:
                w = gr.get_vertex_weight(k1)
            elif (gr.get_vertex_info(k1).rpos == gr.get_vertex_info(k2).lpos
                  and gr.edge(k1, k2) is not None):
                w = gr.get_edge_weight(gr.edge(k1, k2))
            else:
                continue
            ei.samples.add(sample_id)
            ei.count = len(ei.samples)
            ei.spAbd[sample_id] = ei.spAbd.get(sample_id, 0.0) + w
            ei.abd += w

    def start_end_support(self, sample_id, gr, gx):
        """assembler.cc:678-778"""
        n = gx.num_vertices() - 1
        for e in gr.out_edges(0):
            t = e.t
            p = gr.get_vertex_info(t).rpos
            k = gx.locate_vertex(p - 1)
            if k < 0:
                continue
            peb = gx.edge(0, k)
            cont = True
            while peb is None:
                k -= 1
                if k == 0:
                    cont = False
                    break
                if p - gx.get_vertex_info(k).rpos > 200:
                    cont = False
                if gx.get_vertex_info(k + 1).lpos != gx.get_vertex_info(k).rpos:
                    cont = False
                if gx.edge(k, k + 1) is None:
                    cont = False
                if not cont:
                    break
                peb = gx.edge(0, k)
            if not cont or peb is None:
                continue
            ei = gx.get_edge_info(peb)
            ei.samples.add(sample_id)
            ei.count = len(ei.samples)
            ei.spAbd[sample_id] = ei.spAbd.get(sample_id, 0.0) + gr.get_edge_weight(e)
            ei.abd += gr.get_edge_weight(e)
        for e in gr.in_edges(gr.num_vertices() - 1):
            s = e.s
            p = gr.get_vertex_info(s).lpos
            k = gx.locate_vertex(p)
            if k < 0:
                continue
            peb = gx.edge(k, n)
            cont = True
            while peb is None:
                k += 1
                if k == n:
                    cont = False
                    break
                if gx.get_vertex_info(k).lpos - p > 200:
                    cont = False
                if gx.get_vertex_info(k - 1).rpos != gx.get_vertex_info(k).lpos:
                    cont = False
                if gx.edge(k - 1, k) is None:
                    cont = False
                if not cont:
                    break
                peb = gx.edge(k, n)
            if not cont or peb is None:
                continue
            ei = gx.get_edge_info(peb)
            ei.samples.add(sample_id)
            ei.count = len(ei.samples)
            ei.spAbd[sample_id] = ei.spAbd.get(sample_id, 0.0) + gr.get_edge_weight(e)
            ei.abd += gr.get_edge_weight(e)

    def boundary_extend(self, sample_id, gr, gx, pos_type):
        """Record broken-boundary losses of gr inferred from gx
        (assembler.cc:781-901)."""
        n = gr.num_vertices() - 1
        gxn = gx.num_vertices() - 1
        for e in gr.out_edges(0):
            t = e.t
            vi = gr.get_vertex_info(t)
            k = -1
            if pos_type == 1:
                k = gx.locate_vertex(vi.lpos)
            elif pos_type == 2:
                k = gx.locate_vertex(vi.rpos - 1)
            elif pos_type == 3:
                if (t + 1 < n and gr.edge(t, t + 1) is not None and
                        gr.get_vertex_info(t).rpos == gr.get_vertex_info(t + 1).lpos):
                    k = gx.locate_vertex(vi.rpos)
            if k <= 0 or gx.edge(0, k) is not None:
                continue
            ek = gx.edge(k - 1, k)
            if ek is not None and gx.get_vertex_info(k - 1).rpos == gx.get_vertex_info(k).lpos:
                new_loss = gx.get_in_weights(k) - gx.get_edge_weight(ek)
            else:
                new_loss = gx.get_in_weights(k)
            if sample_id == -1 and pos_type == 1:
                vi.boundary_merged_loss += new_loss
            elif pos_type == 1:
                vi.boundary_loss1 += new_loss
            elif pos_type == 2:
                vi.boundary_loss2 += new_loss
            elif pos_type == 3:
                vi.boundary_loss3 += new_loss
        for e in gr.in_edges(n):
            s = e.s
            vi = gr.get_vertex_info(s)
            k = -1
            if pos_type == 1:
                k = gx.locate_vertex(vi.rpos - 1)
            elif pos_type == 2:
                k = gx.locate_vertex(vi.lpos)
            elif pos_type == 3:
                if (s > 1 and gr.edge(s - 1, s) is not None and
                        gr.get_vertex_info(s - 1).rpos == gr.get_vertex_info(s).lpos):
                    k = gx.locate_vertex(vi.lpos - 1)
            if k < 0 or k == gxn or gx.edge(k, gxn) is not None:
                continue
            ek = gx.edge(k, k + 1) if k + 1 <= gxn else None
            if ek is not None and gx.get_vertex_info(k).rpos == gx.get_vertex_info(k + 1).lpos:
                new_loss = gx.get_out_weights(k) - gx.get_edge_weight(ek)
            else:
                new_loss = gx.get_out_weights(k)
            if sample_id == -1 and pos_type == 1:
                vi.boundary_merged_loss += new_loss
            elif pos_type == 1:
                vi.boundary_loss1 += new_loss
            elif pos_type == 2:
                vi.boundary_loss2 += new_loss
            elif pos_type == 3:
                vi.boundary_loss3 += new_loss

    # --------------------------------------------------------- core assembly
    def assemble_graph(self, gx, px, sid):
        """assembler.cc:1075-1136"""
        cfg = self.cfg
        gx.extend_strands()
        smap = group_start_boundaries(gx, cfg.max_group_boundary_distance)
        tmap = group_end_boundaries(gx, cfg.max_group_boundary_distance)
        px.project_boundaries(smap, tmap)
        hx = HyperSet(gx, px)
        hx.filter_nodes(gx)
        gx.gid = gx.gid + ".0"
        sc = Scallop(gx, hx, cfg)
        sc.assemble()
        ts = new_transcript_set(gx.chrm, self.tmerge.rid, cfg)
        for t in sc.trsts:
            if len(t.exons) <= 1 and cfg.skip_single_exon_transcripts:
                continue
            t.RPKM = 0
            ts.add_transcript(t, 1, sid, TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
        self.tmerge.add(ts, TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
