"""Bundle -> splice graph construction.

Re-implements rnacore/graph_builder.{h,cc} (pipeline at graph_builder.cc:24-35):
junction aggregation from hit/fragment chain sets with per-strand counts and
majority-vote strand, opposite-junction removal, region partitioning by splice
positions, partial-exon inference, confidence classification, junction->pexon
linking, and the exact edge-weight rules of build_splice_graph
(graph_builder.cc:299-426) which determine downstream GTF output.
"""

from __future__ import annotations

from ..constants import (END_BOUNDARY, LEFT_RIGHT_SPLICE, LEFT_SPLICE,
                         RIGHT_SPLICE, START_BOUNDARY)
from .chain_set import ChainSet
from .graph import SpliceGraph, VertexInfo
from .regions import Junction, build_region_pexons


class GraphBuilder:
    def __init__(self, bd, cfg):
        self.bd = bd
        self.cfg = cfg
        self.junctions = []
        self.pexons = []
        self.regional = []

    def build(self, gr: SpliceGraph):
        self.build_junctions()
        self.remove_opposite_junctions()
        self.build_regions_and_pexons()
        self.classify_partial_exons()
        self.link_partial_exons()
        self.build_splice_graph(gr)
        refine_splice_graph(gr)
        return gr

    # -------------------------------------------------------------- junctions
    def build_junctions(self):
        """graph_builder.cc:46-125"""
        jcst = ChainSet()
        for cst in (self.bd.hcst, self.bd.fcst):
            for v, a in cst.iter_chains():
                if len(v) <= 0 or len(v) % 2 != 0:
                    continue
                for k in range(len(v) // 2):
                    jcst.add_counts([v[k * 2], v[k * 2 + 1]], a)
        self.junctions = []
        for v, a in jcst.iter_chains():
            if len(v) != 2 or v[0] >= v[1]:
                continue
            count = a[0] + a[1] + a[2]
            if count < self.cfg.min_junction_support:
                continue
            jc = Junction(v[0], v[1], count)
            jc.xs0, jc.xs1, jc.xs2 = a[0], a[1], a[2]
            if jc.xs1 > jc.xs2:
                jc.strand = "+"
            elif jc.xs1 < jc.xs2:
                jc.strand = "-"
            else:
                jc.strand = "."
            self.junctions.append(jc)

    def remove_opposite_junctions(self):
        """Resolve near-duplicate opposite-strand junctions by count and
        mismatch rate (graph_builder.cc:128-175)."""
        cfg = self.cfg
        fb = set()
        js = self.junctions
        for i in range(len(js)):
            if i in fb:
                continue
            for j in range(i + 1, len(js)):
                if j in fb:
                    continue
                x, y = js[i], js[j]
                if x.strand == y.strand:
                    continue
                threshold = cfg.normal_junction_threshold
                z = (x.rpos - x.lpos) - (y.rpos - y.lpos)
                if z == 0 or x.lpos == y.lpos or x.rpos == y.rpos:
                    threshold = cfg.extend_junction_threshold
                d = abs(x.lpos - y.lpos) + abs(x.rpos - y.rpos)
                if d > threshold:
                    continue
                if x.count > y.count and x.nm / x.count < y.nm / y.count:
                    fb.add(j)
                if x.count < y.count and x.nm / x.count > y.nm / y.count:
                    fb.add(i)
        self.junctions = [js[i] for i in range(len(js)) if i not in fb]

    # ---------------------------------------------------------------- regions
    def build_regions_and_pexons(self):
        """graph_builder.cc:177-242"""
        bd = self.bd
        s = {bd.lpos: START_BOUNDARY, bd.rpos: END_BOUNDARY}
        for jc in self.junctions:
            l, r = jc.lpos, jc.rpos
            if l not in s:
                s[l] = LEFT_SPLICE
            elif s[l] == RIGHT_SPLICE:
                s[l] = LEFT_RIGHT_SPLICE
            if r not in s:
                s[r] = RIGHT_SPLICE
            elif s[r] == LEFT_SPLICE:
                s[r] = LEFT_RIGHT_SPLICE
        v = sorted(s.items())
        self.pexons = []
        self.regional = []
        for k in range(len(v) - 1):
            l, ltype = v[k]
            r, rtype = v[k + 1]
            if ltype == LEFT_RIGHT_SPLICE:
                ltype = RIGHT_SPLICE
            if rtype == LEFT_RIGHT_SPLICE:
                rtype = LEFT_SPLICE
            for pe in build_region_pexons(l, r, ltype, rtype, bd.mmap, self.cfg):
                self.pexons.append(pe)
                reg = (pe.lpos != bd.lpos or pe.rpos != bd.rpos) and \
                    pe.ltype == START_BOUNDARY and pe.rtype == END_BOUNDARY
                self.regional.append(reg)

    def classify_partial_exons(self):
        """Confident (pvalue 0) vs suspicious (pvalue 1) pexons
        (graph_builder.cc:477-514)."""
        mj = {}
        for i, jc in enumerate(self.junctions):
            mj[(jc.lpos, jc.rpos)] = i
        bd = self.bd
        for pe in self.pexons:
            b = False
            if pe.lpos == bd.lpos or pe.rpos == bd.rpos:
                b = True
            if pe.ltype == RIGHT_SPLICE or pe.rtype == LEFT_SPLICE:
                b = True
            if pe.ltype == LEFT_SPLICE and pe.rtype == RIGHT_SPLICE:
                p = (pe.lpos, pe.rpos)
                if p not in mj:
                    b = True
                elif self.junctions[mj[p]].count < pe.ave:
                    b = True
            pe.pvalue = 0 if b else 1

    def link_partial_exons(self):
        """graph_builder.cc:244-297"""
        lm = {}
        rm = {}
        for i, pe in enumerate(self.pexons):
            lm[pe.lpos] = i
            rm[pe.rpos] = i
        for jc in self.junctions:
            li = rm.get(jc.lpos, -1)
            ri = lm.get(jc.rpos, -1)
            jc.lexon = li
            jc.rexon = ri

    # ------------------------------------------------------------- the graph
    def build_splice_graph(self, gr: SpliceGraph):
        """graph_builder.cc:299-426"""
        cfg = self.cfg
        bd = self.bd
        gr.strand = bd.strand
        gr.chrm = bd.chrm
        pexons = self.pexons

        gr.add_vertex()
        vi0 = VertexInfo(lpos=bd.lpos, rpos=bd.lpos, type=0)
        gr.set_vertex_weight(0, 0)
        gr.set_vertex_info(0, vi0)
        for i, r in enumerate(pexons):
            length = r.rpos - r.lpos
            assert length >= 1
            gr.add_vertex()
            w = max(r.ave, cfg.min_guaranteed_edge_weight)
            gr.set_vertex_weight(i + 1, w)
            vi = VertexInfo(lpos=r.lpos, rpos=r.rpos, stddev=r.dev,
                            maxcov=r.max, length=length,
                            regional=self.regional[i],
                            type=0 if r.pvalue < 0.5 else 1)
            gr.set_vertex_info(i + 1, vi)
        gr.add_vertex()
        vin = VertexInfo(lpos=bd.rpos, rpos=bd.rpos, type=0)
        gr.set_vertex_weight(len(pexons) + 1, 0)
        gr.set_vertex_info(len(pexons) + 1, vin)

        # junction edges; counts coerced to float so every weight in the
        # graph is a double, like the reference's C++ (keeps feature-CSV
        # number formatting uniform across implementations)
        for b in self.junctions:
            if b.lexon < 0 or b.rexon < 0:
                continue
            p = gr.add_edge(b.lexon + 1, b.rexon + 1)
            ei = gr.get_edge_info(p)
            ei.weight = float(b.count)
            if b.strand == "+":
                ei.strand = 1
            if b.strand == "-":
                ei.strand = 2
            gr.set_edge_weight(p, float(b.count))

        # source/sink edges with neighbor-subtracted weights
        ss = 0
        tt = len(pexons) + 1
        for i, r in enumerate(pexons):
            if r.ltype == START_BOUNDARY:
                p = gr.add_edge(ss, i + 1)
                w = r.ave
                if i >= 1 and pexons[i - 1].rpos == r.lpos:
                    w -= pexons[i - 1].ave
                w = max(w, cfg.min_guaranteed_edge_weight)
                gr.set_edge_weight(p, w)
                gr.get_edge_info(p).weight = w
            if r.rtype == END_BOUNDARY:
                p = gr.add_edge(i + 1, tt)
                w = r.ave
                if i < len(pexons) - 1 and pexons[i + 1].lpos == r.rpos:
                    w -= pexons[i + 1].ave
                w = max(w, cfg.min_guaranteed_edge_weight)
                gr.set_edge_weight(p, w)
                gr.get_edge_info(p).weight = w

        # adjacent-pexon edges weighted by min-ave with degree tie-breaks
        for i in range(len(pexons) - 1):
            x, y = pexons[i], pexons[i + 1]
            if x.rpos != y.lpos:
                continue
            xd = gr.out_degree(i + 1)
            yd = gr.in_degree(i + 2)
            if xd < yd:
                wt = x.ave
            elif xd > yd:
                wt = y.ave
            elif x.ave < y.ave:
                wt = x.ave
            else:
                wt = y.ave
            p = gr.add_edge(i + 1, i + 2)
            wt = max(wt, cfg.min_guaranteed_edge_weight)
            gr.set_edge_weight(p, wt)
            gr.get_edge_info(p).weight = wt
        return gr


def refine_splice_graph(gr: SpliceGraph):
    """Iteratively clear interior vertices lacking in- or out-edges
    (graph_reviser.cc:899-914)."""
    while True:
        b = False
        for i in range(1, gr.num_vertices() - 1):
            if gr.degree(i) == 0:
                continue
            if gr.in_degree(i) >= 1 and gr.out_degree(i) >= 1:
                continue
            gr.clear_vertex(i)
            b = True
        if not b:
            break
