"""Iterative phasing-preserving splice-graph decomposition.

Re-implements scallop/scallop.{h,cc}: the resolution ladder of the main loop
(scallop.cc:47-173) — broken vertices, trivial vertices (fast/slow),
smallest-edge removal, unsplittable/splittable vertex decomposition at
escalating error thresholds — with the super-edge bookkeeping (mev/med/mei),
vertex map v2v, sink exchanging, edge split/merge surgery, sqrt-mean vertex
balancing, termination by existing source->sink paths plus greedy bottleneck
max-path extraction, and transcript construction with the full TrstFeatures
update (scallop.cc:3250-3497).

The loop runs per bundle; bundles are independent and batched at the meta
layer.  random_ordering is always False here (aletsch passes false for the
single assembly round, meta/assembler.cc:1110).
"""

from __future__ import annotations

import math

from ..constants import (SMIN, SPLITTABLE_PURE, TRIVIAL_VERTEX,
                         UNSPLITTABLE_SINGLE)
from ..core.essential import build_transcript
from ..core.paths import Path
from .hyper_set import HyperSet
from .router import Router

INF = float("inf")
INT_MAX = 1 << 31


class Scallop:
    def __init__(self, gr, hs: HyperSet, cfg):
        self.gr = gr
        self.hs = hs
        self.cfg = cfg
        self.paths = []
        self.trsts = []
        # edge indexing
        self.i2e = []
        self.e2i = {}
        for e in gr.edges():
            self.e2i[e] = len(self.i2e)
            self.i2e.append(e)
        hs.build(gr, self.e2i)
        # super edges
        self.mev = {e: [] for e in self.i2e}
        self.med = {e: 0.0 for e in self.i2e}
        self.mei = {e: 0 for e in self.i2e}
        # inner weights
        for e in self.i2e:
            gr.get_edge_info(e).weight = gr.get_edge_weight(e)
        # vertex map + nonzero set
        self.v2v = list(range(gr.num_vertices()))
        self.nonzeroset = set(i for i in range(1, gr.num_vertices() - 1)
                              if gr.degree(i) > 0)

    # -------------------------------------------------------------- main loop
    def assemble(self):
        """scallop.cc:38-188.  arm_counts records which ladder rung fired
        per iteration (the .graph fixture oracle asserts arm coverage,
        tests/test_graph_reference.py)."""
        cfg = self.cfg
        gr_ori = self.gr.copy()
        r = cfg.max_decompose_error_ratio
        self.arm_counts = {"broken": 0, "trivial": 0, "smallest": 0,
                           "unsplittable": 0, "splittable": 0}
        ac = self.arm_counts
        while True:
            if self.gr.num_vertices() > cfg.max_num_exons:
                break
            if self.resolve_broken_vertex():
                ac["broken"] += 1
                continue
            if self.resolve_trivial_vertex_fast(r[TRIVIAL_VERTEX]):
                ac["trivial"] += 1
                continue
            if self.resolve_trivial_vertex(1, True, r[TRIVIAL_VERTEX]):
                ac["trivial"] += 1
                continue
            if self.resolve_smallest_edges(r[0]):
                ac["smallest"] += 1
                continue
            if self.resolve_unsplittable_vertex(UNSPLITTABLE_SINGLE, 1, 0.01):
                ac["unsplittable"] += 1
                continue
            if self.resolve_unsplittable_vertex(SPLITTABLE_PURE, 1, 0.01):
                ac["splittable"] += 1
                continue
            if self.resolve_unsplittable_vertex(UNSPLITTABLE_SINGLE, INT_MAX,
                                                r[UNSPLITTABLE_SINGLE]):
                ac["unsplittable"] += 1
                continue
            if self.resolve_unsplittable_vertex(SPLITTABLE_PURE, INT_MAX,
                                                r[SPLITTABLE_PURE]):
                ac["splittable"] += 1
                continue
            if self.resolve_unsplittable_vertex(UNSPLITTABLE_SINGLE, INT_MAX, INF):
                ac["unsplittable"] += 1
                continue
            if self.resolve_unsplittable_vertex(SPLITTABLE_PURE, INT_MAX, INF):
                ac["splittable"] += 1
                continue
            if self.resolve_trivial_vertex(2, True, r[TRIVIAL_VERTEX]):
                ac["trivial"] += 1
                continue
            break
        self.collect_existing_st_paths()
        self.greedy_decompose()
        self.build_transcripts(gr_ori)
        return self.trsts

    # ------------------------------------------------------- broken vertices
    def resolve_broken_vertex(self):
        """scallop.cc:190-236"""
        gr = self.gr
        x = -1
        for i in sorted(self.nonzeroset):
            if i == 0 or i == gr.num_vertices() - 1:
                continue
            if gr.in_degree(i) >= 1 and gr.out_degree(i) >= 1:
                continue
            x = i
            break
        if x == -1:
            return False
        ve = [self.e2i[e] for e in gr.in_edges(x)] + \
             [self.e2i[e] for e in gr.out_edges(x)]
        for e in ve:
            self.remove_edge(e)
            self.hs.remove(e)
        self.nonzeroset.discard(x)
        return True

    # ------------------------------------------------------ trivial vertices
    def classify_trivial_vertex(self, x, fast):
        """scallop.cc:2169-2196"""
        gr = self.gr
        d1 = gr.in_degree(x)
        d2 = gr.out_degree(x)
        if d1 != 1 and d2 != 1:
            return -1
        e1 = self.e2i[gr.in_edges(x)[0]]
        e2 = self.e2i[gr.out_edges(x)[0]]
        if d1 == 1:
            s = self.i2e[e1].s
            if gr.out_degree(s) == 1:
                return 1
            if fast and self.hs.right_dominate(e1):
                return 1
        if d2 == 1:
            t = self.i2e[e2].t
            if gr.in_degree(t) == 1:
                return 1
            if fast and self.hs.left_dominate(e2):
                return 1
        return 2

    def compute_balance_ratio(self, v):
        """scallop.cc:2578-2602"""
        gr = self.gr
        w1 = gr.get_in_weights(v)
        w2 = gr.get_out_weights(v)
        return w1 / w2 if w1 >= w2 else w2 / w1

    def resolve_single_trivial_vertex(self, i, jump_ratio):
        """scallop.cc:1236-1254"""
        gr = self.gr
        if gr.in_degree(i) <= 0 or gr.out_degree(i) <= 0:
            return False
        if gr.in_degree(i) >= 2 and gr.out_degree(i) >= 2:
            return False
        if gr.mixed_strand_vertex(i):
            return False
        if self.classify_trivial_vertex(i, False) != 1:
            return False
        r = self.compute_balance_ratio(i)
        if r >= jump_ratio:
            return False
        self.decompose_trivial_vertex(i)
        return True

    def resolve_trivial_vertex_fast(self, jump_ratio):
        """scallop.cc:1256-1269"""
        flag = False
        for i in sorted(self.nonzeroset):
            if i not in self.nonzeroset:
                continue
            if self.resolve_single_trivial_vertex(i, jump_ratio):
                flag = True
        return flag

    def resolve_trivial_vertex(self, type_, fast, jump_ratio):
        """scallop.cc:1180-1234"""
        gr = self.gr
        root = -1
        ratio = INF
        flag = False
        for i in sorted(self.nonzeroset):
            if i not in self.nonzeroset:
                continue
            if gr.in_degree(i) <= 0 or gr.out_degree(i) <= 0:
                continue
            if gr.mixed_strand_vertex(i):
                continue
            if gr.in_degree(i) >= 2 and gr.out_degree(i) >= 2:
                continue
            if self.classify_trivial_vertex(i, fast) != type_:
                continue
            r = self.compute_balance_ratio(i)
            if r < 1.02:
                self.decompose_trivial_vertex(i)
                flag = True
                continue
            if ratio < r:
                continue
            root = i
            ratio = r
            if ratio < jump_ratio:
                break
        if flag:
            return True
        if root == -1:
            return False
        self.decompose_trivial_vertex(root)
        return True

    def decompose_trivial_vertex(self, x):
        """scallop.cc:2144-2167"""
        self.balance_vertex(x)
        gr = self.gr
        pe2w = {}
        for ein in gr.in_edges(x):
            e1 = self.e2i[ein]
            w1 = gr.get_edge_weight(ein)
            for eout in gr.out_edges(x):
                e2 = self.e2i[eout]
                w2 = gr.get_edge_weight(eout)
                pe2w[(e1, e2)] = min(w1, w2)
        self.decompose_vertex_replace(x, pe2w)

    # -------------------------------------------------------- smallest edges
    def compute_smallest_in_edge(self, x):
        """scallop.cc:2967-2986; returns (edge index, ratio) or (-1, 0)."""
        gr = self.gr
        e = -1
        s1 = 0.0
        minw = INF
        for ein in gr.in_edges(x):
            w = gr.get_edge_weight(ein)
            s1 += w
            if w > minw:
                continue
            minw = w
            e = self.e2i[ein]
        if e == -1:
            return -1, 0.0
        return e, minw / s1

    def compute_smallest_out_edge(self, x):
        """scallop.cc:2988-3007"""
        gr = self.gr
        e = -1
        s1 = 0.0
        minw = INF
        for eout in gr.out_edges(x):
            w = gr.get_edge_weight(eout)
            s1 += w
            if w > minw:
                continue
            minw = w
            e = self.e2i[eout]
        if e == -1:
            return -1, 0.0
        return e, minw / s1

    def compute_smallest_edge(self, x):
        """scallop.cc:3009-3030"""
        e1, r1 = self.compute_smallest_in_edge(x)
        e2, r2 = self.compute_smallest_out_edge(x)
        if e1 < 0 or e2 < 0:
            return -1, 0.0
        if r1 < r2:
            return e1, r1
        return e2, r2

    def resolve_smallest_edges(self, max_ratio):
        """scallop.cc:844-945"""
        gr = self.gr
        hs = self.hs
        se = -1
        ratio = max_ratio
        flag = False
        for i in sorted(self.nonzeroset):
            if i not in self.nonzeroset:
                continue
            if gr.in_degree(i) <= 1 or gr.out_degree(i) <= 1:
                continue
            e, r = self.compute_smallest_edge(i)
            if e == -1:
                continue
            s = self.i2e[e].s
            t = self.i2e[e].t
            if gr.out_degree(s) <= 1 or gr.in_degree(t) <= 1:
                continue
            if hs.right_extend(e) and hs.left_extend(e):
                continue
            if t == i and hs.right_extend(e):
                continue
            if s == i and hs.left_extend(e):
                continue
            vs = gr.get_strand_degree(i)
            z = gr.get_edge_info(self.i2e[e]).strand
            if s == i and z >= 1 and vs[0] + vs[z] <= 1:
                continue
            if t == i and z >= 1 and vs[3] + vs[z + 3] <= 1:
                continue
            if r < 0.01:
                self.remove_edge(e)
                hs.remove(e)
                flag = True
                continue
            if ratio < r:
                continue
            ratio = r
            se = e
        if flag:
            return True
        if se == -1:
            return False
        self.remove_edge(se)
        hs.remove(se)
        return True

    # -------------------------------------------------- unsplittable vertices
    def resolve_unsplittable_vertex(self, type_, degree, max_ratio):
        """scallop.cc:1004-1060"""
        gr = self.gr
        root = -1
        pe2w = None
        ratio = max_ratio
        flag = False
        for i in sorted(self.nonzeroset):
            if i not in self.nonzeroset:
                continue
            if gr.in_degree(i) <= 1 or gr.out_degree(i) <= 1:
                continue
            mpi = self.hs.get_routes(i, gr, self.e2i)
            rt = Router(i, gr, self.e2i, self.i2e, mpi, self.cfg)
            rt.classify()
            if rt.type != type_ or rt.degree > degree:
                continue
            rt.build()
            if rt.ratio < 0.01:
                self.decompose_vertex_extend(i, rt.pe2w)
                flag = True
                continue
            if rt.ratio > ratio:
                continue
            root = i
            ratio = rt.ratio
            pe2w = rt.pe2w
        if flag:
            return True
        if root == -1:
            return False
        self.decompose_vertex_extend(root, pe2w)
        return True

    # ------------------------------------------------------- vertex surgery
    def exchange_sink(self, old_sink, new_sink):
        """scallop.cc:2198-2215"""
        gr = self.gr
        for e in gr.in_edges(old_sink):
            gr.move_edge(e, e.s, new_sink)
        assert gr.degree(old_sink) == 0

    def consistent_strands(self, e1, e2):
        s1 = self.gr.get_edge_info(self.i2e[e1]).strand
        s2 = self.gr.get_edge_info(self.i2e[e2]).strand
        if s1 == 1 and s2 == 2:
            return False
        if s1 == 2 and s2 == 1:
            return False
        return True

    def borrow_edge_strand(self, e1, e2):
        """Set e1's strand from e2 if e2 is stranded (scallop.cc:1997-2007)."""
        gr = self.gr
        s2 = gr.get_edge_info(self.i2e[e2]).strand
        if s2 == 0:
            return
        gr.get_edge_info(self.i2e[e1]).strand = s2

    def decompose_vertex_extend(self, root, pe2w):
        """scallop.cc:1675-1986"""
        gr = self.gr
        cfg = self.cfg
        mdegree = {}
        mweight = {}
        total_weight = 0.0
        for (e1, e2), w in pe2w.items():
            mdegree[e1] = mdegree.get(e1, 0) + 1
            mdegree[e2] = mdegree.get(e2, 0) + 1
            total_weight += w
            mweight[e1] = mweight.get(e1, 0.0) + w
            mweight[e2] = mweight.get(e2, 0.0) + w
        root_info = gr.get_vertex_info(root)
        root_len = root_info.rpos - root_info.lpos
        vertex_weight = gr.get_vertex_weight(root) * root_len
        for k in mweight:
            mweight[k] = mweight[k] / total_weight * vertex_weight

        m = gr.num_vertices() - 1
        n = m
        ev1 = {}
        ev2 = {}
        for e in gr.in_edges(root):
            ei = self.e2i[e]
            if mdegree[ei] >= 2:
                ev1[ei] = n
                n += 1
        for e in gr.out_edges(root):
            ei = self.e2i[e]
            if mdegree[ei] >= 2:
                ev2[ei] = n
                n += 1
        for (e1, e2) in sorted(pe2w.keys()):
            if mdegree[e1] == 1 and mdegree[e2] == 1:
                ev1[e1] = n
                n += 1

        for i in range(m, n):
            gr.add_vertex()
            self.nonzeroset.add(i)
            self.v2v.append(-1)
        if m != n:
            self.v2v[n] = self.v2v[m]
            gr.set_vertex_info(n, gr.get_vertex_info(m))
            self.exchange_sink(m, n)

        # detach adjacent edges onto aux vertices
        from ..core.graph import VertexInfo
        for ei in sorted(ev1.keys()):
            e = self.i2e[ei]
            k = ev1[ei]
            p = gr.get_vertex_info(e.s).rpos
            gr.move_edge(e, e.s, k)
            gr.set_vertex_info(k, VertexInfo(lpos=p, rpos=p))
            gr.set_vertex_weight(k, 0)
            self.v2v[k] = -2
        for ei in sorted(ev2.keys()):
            e = self.i2e[ei]
            k = ev2[ei]
            p = gr.get_vertex_info(e.t).lpos
            gr.move_edge(e, k, e.t)
            gr.set_vertex_info(k, VertexInfo(lpos=p, rpos=p))
            gr.set_vertex_weight(k, 0)
            self.v2v[k] = -2

        # connect according to pe2w
        for (e1, e2) in sorted(pe2w.keys()):
            w = pe2w[(e1, e2)]
            if mdegree[e1] == 1 and mdegree[e2] >= 2:
                p = self.i2e[e1]
                self.borrow_edge_strand(e1, e2)
                gr.move_edge(p, p.s, ev2[e2])
                self.mev[p].append(root)
                self.med[p] += mweight[e1]
                self.mei[p] += root_len
            elif mdegree[e2] == 1:
                p = self.i2e[e2]
                self.borrow_edge_strand(e2, e1)
                gr.move_edge(p, ev1[e1], p.t)
                self.mev[p].insert(0, root)
                self.med[p] += mweight[e2]
                self.mei[p] += root_len
            else:
                v1 = ev1[e1]
                v2 = ev2[e2]
                p = gr.add_edge(v1, v2)
                z = len(self.i2e)
                self.i2e.append(p)
                self.e2i[p] = z
                gr.set_edge_weight(p, w)
                ei1 = gr.get_edge_info(self.i2e[e1])
                ei2 = gr.get_edge_info(self.i2e[e2])
                ei = gr.get_edge_info(p)
                ei.samples = ei1.samples & ei2.samples
                ei.count = len(ei.samples)
                ei.abd = 0.0
                ei.spAbd = {}
                # sorted sample order: the abd float accumulation must not
                # depend on set-iteration order
                for sp in sorted(ei.samples):
                    common = min(ei1.spAbd.get(sp, 0.0), ei2.spAbd.get(sp, 0.0))
                    ei.spAbd[sp] = common
                    ei.abd += common
                self.mev[p] = [root]
                self.med[p] = w / total_weight * vertex_weight
                self.mei[p] = root_len
                self.borrow_edge_strand(z, e1)
                self.borrow_edge_strand(z, e2)
                self.hs.insert_between(e1, e2, z)

        assert gr.degree(root) == 0
        self.nonzeroset.discard(root)

        for ei in sorted(ev1.keys()):
            self.resolve_single_trivial_vertex(
                ev1[ei], cfg.max_decompose_error_ratio[TRIVIAL_VERTEX])
        for ei in sorted(ev2.keys()):
            self.resolve_single_trivial_vertex(
                ev2[ei], cfg.max_decompose_error_ratio[TRIVIAL_VERTEX])

    def decompose_vertex_replace(self, root, pe2w):
        """scallop.cc:2009-2142"""
        gr = self.gr
        hs = self.hs
        md = {}
        for (e1, e2), w in pe2w.items():
            md[e1] = md.get(e1, 0.0) + w
            md[e2] = md.get(e2, 0.0) + w
        for e, w in md.items():
            gr.set_edge_weight(self.i2e[e], w)
        # drop hyper routes not covered
        mpi = hs.get_routes(root, gr, self.e2i)
        for pair in mpi:
            if pair in pe2w:
                continue
            hs.remove_pair(pair[0], pair[1])
        m = {}
        for (e1, e2) in pe2w:
            m[e1] = m.get(e1, 0) + 1
            m[e2] = m.get(e2, 0) + 1
        for (e1, e2) in sorted(pe2w.keys()):
            w = pe2w[(e1, e2)]
            e = self.merge_adjacent_edges_w(e1, e2, w)
            hs.replace_pair(e1, e2, e)
            if m[e1] == 1:
                hs.replace(e1, e)
            if m[e2] == 1:
                hs.replace(e2, e)
        for (e1, e2) in sorted(pe2w.keys()):
            hs.remove(e1)
            hs.remove(e2)
        assert gr.degree(root) == 0
        self.nonzeroset.discard(root)

    # ----------------------------------------------------------- edge surgery
    def remove_edge(self, e):
        """scallop.cc:2380-2392"""
        ee = self.i2e[e]
        del self.e2i[ee]
        self.i2e[e] = None
        self.gr.remove_edge(ee)

    def split_edge(self, ei, w):
        """scallop.cc:2433-2484"""
        gr = self.gr
        cfg = self.cfg
        ee = self.i2e[ei]
        ww = gr.get_edge_weight(ee)
        if abs(ww - w) <= SMIN:
            return ei
        p2 = gr.add_edge(ee.s, ee.t)
        eif = gr.get_edge_info(ee)
        www = ww - w
        if www <= cfg.min_guaranteed_edge_weight:
            www = cfg.min_guaranteed_edge_weight
        gr.set_edge_weight(ee, www)
        gr.set_edge_weight(p2, w)
        gr.set_edge_info(p2, eif.copy())
        self.mev[p2] = list(self.mev[ee])
        self.med[p2] = self.med[ee] * w / ww if ww != 0 else 0.0
        self.mei[p2] = self.mei[ee]
        n = len(self.i2e)
        self.i2e.append(p2)
        self.e2i[p2] = n
        return n

    def merge_adjacent_equal_edges(self, x, y):
        """scallop.cc:2242-2378"""
        gr = self.gr
        if self.i2e[x] is None or self.i2e[y] is None:
            return -1
        xx = self.i2e[x]
        yy = self.i2e[y]
        xs, xt = xx.s, xx.t
        ys, yt = yy.s, yy.t
        if xt != ys and yt != xs:
            return -1
        if yt == xs:
            return self.merge_adjacent_equal_edges(y, x)
        p = gr.add_edge(xs, yt)
        n = len(self.i2e)
        self.i2e.append(p)
        self.e2i[p] = n
        wx0 = gr.get_edge_weight(xx)
        wy0 = gr.get_edge_weight(yy)
        ei1 = gr.get_edge_info(xx)
        ei2 = gr.get_edge_info(yy)
        lxy = ei1.length + ei2.length + gr.get_vertex_info(xt).length
        gr.set_edge_weight(p, wx0 * 0.5 + wy0 * 0.5)
        ei = gr.get_edge_info(p)
        ei.length = lxy
        ei.samples = ei1.samples & ei2.samples
        ei.count = len(ei.samples)
        ei.abd = 0.0
        ei.spAbd = {}
        for sp in sorted(ei.samples):   # canonical float-sum order
            common = min(ei1.spAbd.get(sp, 0.0), ei2.spAbd.get(sp, 0.0))
            ei.spAbd[sp] = common
            ei.abd += common
        ei.confidence = ei1.confidence + ei2.confidence
        self.borrow_edge_strand(n, x)
        self.borrow_edge_strand(n, y)
        self.mev[p] = list(self.mev[xx]) + [xt] + list(self.mev[yy])
        sum1 = gr.get_in_weights(xt)
        sum2 = gr.get_out_weights(xt)
        ssum = (sum1 + sum2) * 0.5
        r1 = gr.get_vertex_weight(xt) * (wx0 + wy0) * 0.5 / ssum if ssum > 0 else 0.0
        r2 = gr.get_vertex_weight(xt) - r1
        gr.set_vertex_weight(xt, r2)
        root_info = gr.get_vertex_info(xt)
        mi = root_info.rpos - root_info.lpos + self.mei[xx] + self.mei[yy]
        mdv = mi * r1 + self.med[xx] + self.med[yy]
        self.med[p] = mdv
        self.mei[p] = mi
        self.remove_edge(x)
        self.remove_edge(y)
        if gr.in_degree(xt) == 0 and gr.out_degree(xt) == 0:
            self.nonzeroset.discard(xt)
        return n

    def merge_adjacent_edges_w(self, x, y, ww):
        """scallop.cc:2394-2416"""
        if self.i2e[x] is None or self.i2e[y] is None:
            return -1
        xx = self.i2e[x]
        yy = self.i2e[y]
        if xx.t != yy.s:
            return self.merge_adjacent_edges_w(y, x, ww)
        x1 = self.split_edge(x, ww)
        y1 = self.split_edge(y, ww)
        return self.merge_adjacent_equal_edges(x1, y1)

    def merge_adjacent_edges(self, x, y):
        """scallop.cc:2418-2431"""
        if self.i2e[x] is None or self.i2e[y] is None:
            return -1
        wx = self.gr.get_edge_weight(self.i2e[x])
        wy = self.gr.get_edge_weight(self.i2e[y])
        return self.merge_adjacent_edges_w(x, y, min(wx, wy))

    def split_merge_path(self, edges, ww):
        """scallop.cc:2217-2240"""
        if len(edges) == 0:
            return -1
        v = [self.e2i[e] for e in edges]
        ee = self.split_edge(v[0], ww)
        for i in range(1, len(v)):
            x = self.split_edge(v[i], ww)
            ee = self.merge_adjacent_equal_edges(ee, x)
        return ee

    # -------------------------------------------------------------- balancing
    def balance_vertex(self, v):
        """scallop.cc:2486-2576"""
        gr = self.gr
        cfg = self.cfg
        if gr.in_degree(v) <= 0 or gr.out_degree(v) <= 0:
            return
        ve1 = gr.in_edges(v)
        ve2 = gr.out_edges(v)
        w1 = sum(gr.get_edge_weight(e) for e in ve1)
        w2 = sum(gr.get_edge_weight(e) for e in ve2)
        ww = math.sqrt(w1 * w2)
        r1 = ww / w1
        r2 = ww / w2
        m1 = m2 = 0.0
        for e in ve1:
            wy = gr.get_edge_weight(e) * r1
            if wy < cfg.min_guaranteed_edge_weight:
                m1 += cfg.min_guaranteed_edge_weight - wy
                wy = cfg.min_guaranteed_edge_weight
            gr.set_edge_weight(e, wy)
        for e in ve2:
            wy = gr.get_edge_weight(e) * r2
            if wy < cfg.min_guaranteed_edge_weight:
                m2 += cfg.min_guaranteed_edge_weight - wy
                wy = cfg.min_guaranteed_edge_weight
            gr.set_edge_weight(e, wy)
        if m1 > m2:
            e = ve2[0]
            gr.set_edge_weight(e, gr.get_edge_weight(e) + m1 - m2)
        elif m1 < m2:
            e = ve1[0]
            gr.set_edge_weight(e, gr.get_edge_weight(e) + m2 - m1)

    # ----------------------------------------------------------- termination
    def collect_existing_st_paths(self):
        """scallop.cc:2742-2752"""
        for i in range(len(self.i2e)):
            e = self.i2e[i]
            if e is None:
                continue
            if e.s != 0 or e.t != self.gr.num_vertices() - 1:
                continue
            self.collect_path(i)

    def collect_path(self, e):
        """scallop.cc:2766-2834"""
        gr = self.gr
        ee = self.i2e[e]
        v0 = self.mev[ee]
        v = []
        mi = 0
        for u in v0:
            if self.v2v[u] < 0:
                continue
            v.append(self.v2v[u])
            vi = gr.get_vertex_info(self.v2v[u])
            mi += vi.rpos - vi.lpos
        v.sort()
        n = self.v2v[gr.num_vertices() - 1]
        v = [0] + v + [n]
        # filter paths through empty vertices
        empty = any(gr.get_vertex_info(x).type == -9 for x in v)
        if not empty and len(v) >= 3:
            ei = gr.get_edge_info(ee)
            p = Path()
            p.length = mi
            p.weight = gr.get_edge_weight(ee)
            p.abd = ei.abd
            p.conf = math.exp(min(ei.confidence, 700.0))
            p.reads = self.med[ee]
            p.v = v
            p.count = ei.count
            p.junc = []
            for i in range(2, len(v) - 1):
                if gr.get_vertex_info(v[i]).lpos != gr.get_vertex_info(v[i - 1]).rpos:
                    p.junc.append((v[i - 1], v[i]))
            if ei.strand == 1:
                p.strand = "+"
            elif ei.strand == 2:
                p.strand = "-"
            else:
                p.strand = gr.strand
            self.paths.append(p)
        gr.remove_edge(ee)
        del self.e2i[ee]
        self.i2e[e] = None

    def greedy_decompose(self):
        """scallop.cc:2874-2897"""
        gr = self.gr
        if gr.num_edges() == 0:
            return
        for i in range(1, gr.num_vertices() - 1):
            self.balance_vertex(i)
        for i in range(1, gr.num_vertices() - 1):
            self.balance_vertex(i)
        while True:
            w, vpath = gr.compute_maximum_path_w()
            if w < 0:
                break
            if w <= self.cfg.min_transcript_coverage:
                break
            e = self.split_merge_path(vpath, w)
            if e < 0:
                break
            self.collect_path(e)

    # ------------------------------------------------------------ transcripts
    def build_transcripts(self, gr_ori):
        """scallop.cc:3250-3266"""
        self.trsts = []
        for i, p in enumerate(self.paths):
            tid = "chr%s.%s.%d" % (gr_ori.chrm, gr_ori.gid, i)
            trst = build_transcript(gr_ori, p, tid)
            update_trst_features(gr_ori, trst, i, self.paths)
            self.trsts.append(trst)
        return self.trsts


def unique_junc(paths, i):
    """Junctions unique to path i (scallop.cc:3472-3497)."""
    junc_uni = {}
    for idx, p in enumerate(paths):
        for pair in p.junc:
            if pair not in junc_uni:
                junc_uni[pair] = idx
            elif junc_uni[pair] != idx:
                junc_uni[pair] = -1
    return sum(1 for pair in paths[i].junc if junc_uni.get(pair) == i)


def update_trst_features(gr, trst, pid, paths):
    """Fill the ~40-field TrstFeatures from the final path set and the
    original graph (scallop.cc:3268-3451)."""
    p = paths[pid]
    f = trst.features
    n = len(p.v)
    assert n >= 3
    f.num_vertices = n - 2
    f.num_edges = n - 3
    f.gr_vertices = gr.num_vertices()
    f.gr_edges = gr.num_edges()
    f.gr_reads = gr.reads
    f.gr_subgraph = gr.subgraph
    f.max_mid_exon_len = 0

    junc = len(p.junc)
    if junc == 0:
        return

    start_v = p.junc[0][0]
    end_v = p.junc[-1][1]
    try:
        it_s = p.v.index(start_v)
        it_t = p.v.index(end_v)
    except ValueError:
        return
    f.junc_ratio = junc / (it_t - it_s) if it_t != it_s else 0.0

    for i in range(1, junc):
        exon_len = (gr.get_vertex_info(p.junc[i][0]).rpos
                    - gr.get_vertex_info(p.junc[i - 1][1]).lpos)
        f.max_mid_exon_len = max(f.max_mid_exon_len, exon_len)

    svi = gr.get_vertex_info(p.v[1])
    evi = gr.get_vertex_info(p.v[n - 2])
    f.start_loss1 = svi.boundary_loss1
    f.start_loss2 = svi.boundary_loss2
    f.start_loss3 = svi.boundary_loss3
    f.end_loss1 = evi.boundary_loss1
    f.end_loss2 = evi.boundary_loss2
    f.end_loss3 = evi.boundary_loss3
    f.start_merged_loss = svi.boundary_merged_loss
    f.end_merged_loss = evi.boundary_merged_loss
    f.uni_junc = unique_junc(paths, pid)

    def _edge_w(v1, v2):
        e = gr.edge(v1, v2)
        return None if e is None else gr.get_edge_weight(e)

    def _intron_ratio(v1, v2):
        e = gr.edge(v1, v2)
        e1 = gr.edge(v1, v1 + 1)
        e2 = gr.edge(v2 - 1, v2)
        if e is None or e1 is None or e2 is None:
            return None
        denom = min(gr.get_edge_weight(e1), gr.get_edge_weight(e2))
        if denom <= 0:
            return None
        return gr.get_edge_weight(e) / denom

    f.introns = 0
    f.start_introns = 0
    f.end_introns = 0
    f.intron_ratio = 0.0
    f.start_intron_ratio = 0.0
    f.end_intron_ratio = 0.0
    junc1 = p.junc
    for i2, other in enumerate(paths):
        if i2 == pid:
            continue
        junc2 = other.junc
        if len(junc1) < 2 or len(junc2) < 1:
            continue
        intron_cnt = 0
        start_intron = 0
        end_intron = 0
        for i in range(len(junc1)):
            for j in range(len(junc2)):
                if i == 0 and junc2[j][0] >= p.v[1] and junc2[j][1] <= junc1[0][0]:
                    start_intron += 1
                    r = _intron_ratio(junc2[j][0], junc2[j][1])
                    if r is not None:
                        f.start_intron_ratio = max(f.start_intron_ratio, r)
                elif i > 0 and junc2[j][1] <= junc1[i][0] and junc2[j][0] >= junc1[i - 1][1]:
                    intron_cnt += 1
                    r = _intron_ratio(junc2[j][0], junc2[j][1])
                    if r is not None:
                        f.intron_ratio = max(f.intron_ratio, r)
                if i == len(junc1) - 1 and junc2[j][0] >= junc1[i][1] and junc2[j][1] <= p.v[n - 2]:
                    end_intron += 1
                    r = _intron_ratio(junc2[j][0], junc2[j][1])
                    if r is not None:
                        f.end_intron_ratio = max(f.end_intron_ratio, r)
        f.introns = max(f.introns, intron_cnt)
        f.start_introns = max(f.start_introns, start_intron)
        f.end_introns = max(f.end_introns, end_intron)

    f.seq_min_wt = float("inf")
    f.seq_min_cnt = INT_MAX
    f.seq_min_abd = float("inf")
    f.seq_min_ratio = 1.0
    f.seq_max_wt = 0.0
    f.seq_max_cnt = 0
    f.seq_max_abd = 0.0
    f.seq_max_ratio = 0.0
    f.unbridge_start_coming_count = 0
    f.unbridge_start_coming_ratio = 0.0
    f.unbridge_end_leaving_count = 0
    f.unbridge_end_leaving_ratio = 0.0

    for i in range(1, n):
        v1, v2 = p.v[i - 1], p.v[i]
        e = gr.edge(v1, v2)
        if e is None:
            continue
        ei = gr.get_edge_info(e)
        w = gr.get_edge_weight(e)
        vi2 = gr.get_vertex_info(v2)
        denom = max(gr.get_in_weights(v2), gr.get_out_weights(v1))
        ratio = w / denom if denom > 0 else 0.0
        f.seq_min_wt = min(f.seq_min_wt, w)
        f.seq_min_cnt = min(f.seq_min_cnt, ei.count)
        f.seq_min_abd = min(f.seq_min_abd, ei.abd)
        f.seq_min_ratio = min(f.seq_min_ratio, ratio)
        f.seq_max_wt = max(f.seq_max_wt, w)
        f.seq_max_cnt = max(f.seq_max_cnt, ei.count)
        f.seq_max_abd = max(f.seq_max_abd, ei.abd)
        f.seq_max_ratio = max(f.seq_max_ratio, ratio)
        if i == 1:
            f.unbridge_start_coming_count = vi2.unbridge_coming_count
            f.unbridge_start_coming_ratio = vi2.unbridge_coming_ratio
            f.start_cnt = ei.count
            f.start_weight = w
            f.start_abd = ei.abd
        elif i == n - 2:
            f.unbridge_end_leaving_count = vi2.unbridge_leaving_count
            f.unbridge_end_leaving_ratio = vi2.unbridge_leaving_ratio
        elif i == n - 1:
            f.end_cnt = ei.count
            f.end_weight = w
            f.end_abd = ei.abd
    if f.seq_min_wt == float("inf"):
        f.seq_min_wt = 0.0
    if f.seq_min_abd == float("inf"):
        f.seq_min_abd = 0.0
    if f.seq_min_cnt == INT_MAX:
        f.seq_min_cnt = 0
