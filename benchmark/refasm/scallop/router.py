"""Per-vertex decomposition decisions.

Re-implements scallop/router.{h,cc}: a bipartite graph over the in-edge and
out-edge slots of a vertex with phasing routes as edges, isolated-slot rescue
via cross-sample abundance, connected-component classification
(UNSPLITTABLE_SINGLE vs SPLITTABLE_PURE), per-component sqrt-balanced weight
smoothing, and the leaf/turn greedy threading that produces the
(in-edge, out-edge) -> weight decomposition with a leftover ratio.
"""

from __future__ import annotations

import math

from ..constants import SPLITTABLE_PURE, TRIVIAL, UNSPLITTABLE_SINGLE
from .subsetsum import Equation, SubsetSum
from .ugraph import UGraph


class Router:
    def __init__(self, root, gr, e2i, i2e, mpi, cfg):
        self.root = root
        self.gr = gr
        self.e2i = e2i
        self.i2e = i2e
        self.cfg = cfg
        self.routes = list(mpi.keys())
        self.counts = [mpi[k] for k in self.routes]
        self.type = -1
        self.degree = -1
        self.ratio = -1.0
        self.eqns = []
        self.pe2w = {}
        self.econf = {}     # Edge -> confidence increment
        self.u2e = []
        self.e2u = {}
        self.ug = UGraph()
        self.u2w = {}

    # --------------------------------------------------------------- classify
    def classify(self):
        """router.cc:61-171 (plain-vertex branch)."""
        gr = self.gr
        root = self.root
        assert gr.in_degree(root) >= 1 and gr.out_degree(root) >= 1
        self._build_indices()
        self._build_bipartite_graph()
        if gr.in_degree(root) == 1 or gr.out_degree(root) == 1:
            self.type = TRIVIAL
            self.degree = gr.degree(root)
            return
        vv = self.ug.compute_connected_components()
        if len(vv) == 1:
            self.type = UNSPLITTABLE_SINGLE
            self.degree = self.ug.num_edges() - self.ug.num_vertices() + 2 * len(vv)
            return
        a = sum(1 for c in vv if len(c) == 1)
        b = sum(1 for c in vv if len(c) >= 2)
        self.type = SPLITTABLE_PURE
        self.degree = b - 1 + (a + 1) // 2

    def _build_indices(self):
        """router.cc:225-248"""
        self.e2u = {}
        self.u2e = []
        for e in self.gr.in_edges(self.root):
            idx = self.e2i[e]
            self.e2u[idx] = len(self.u2e)
            self.u2e.append(idx)
        for e in self.gr.out_edges(self.root):
            idx = self.e2i[e]
            self.e2u[idx] = len(self.u2e)
            self.u2e.append(idx)

    def _build_bipartite_graph(self):
        """router.cc:250-325"""
        gr = self.gr
        root = self.root
        self.ug = UGraph()
        self.u2w = {}
        for _ in self.u2e:
            self.ug.add_vertex()
        l = gr.in_degree(root)
        left = []
        right = []
        for i, ei in enumerate(self.u2e):
            e = self.i2e[ei]
            if gr.get_edge_info(e).count != 0:
                (left if i < l else right).append(i)
        for i, (e1, e2) in enumerate(self.routes):
            s = self.e2u[e1]
            t = self.e2u[e2]
            e = self.ug.add_edge(s, t)
            self.u2w[e] = float(self.counts[i])
        v1 = [i for i in left if self.ug.degree(i) == 0]
        self._thread_left_isolate(v1, right)
        v2 = [i for i in right if self.ug.degree(i) == 0]
        self._thread_right_isolate(v2, left)

    def _common_abd(self, le_info, re_info):
        common = le_info.samples & re_info.samples
        abd = 0.0
        for sp in sorted(common):   # canonical float-sum order
            a = le_info.spAbd.get(sp, 0.0)
            b = re_info.spAbd.get(sp, 0.0)
            abd += 0.99 * min(a, b) + 0.01 * max(a, b)
        return abd

    def _thread_left_isolate(self, left_iso, right_all):
        """Rescue isolated in-slots by best shared-sample abundance
        (router.cc:1010-1069)."""
        gr = self.gr
        for v in left_iso:
            le = self.i2e[self.u2e[v]]
            le_info = gr.get_edge_info(le)
            partner = -1
            max_abd = 0.0
            sum_abd = 0.0
            for r in right_all:
                re = self.i2e[self.u2e[r]]
                ca = self._common_abd(le_info, gr.get_edge_info(re))
                sum_abd += ca
                if ca > max_abd:
                    max_abd = ca
                    partner = r
            if partner < 0:
                continue
            e = self.ug.add_edge(v, partner)
            self.u2w[e] = max_abd
            self.econf[le] = math.log(max_abd / sum_abd) if sum_abd > 0 else 0.0

    def _thread_right_isolate(self, right_iso, left_all):
        """router.cc:1071-1129"""
        gr = self.gr
        for v in right_iso:
            re = self.i2e[self.u2e[v]]
            re_info = gr.get_edge_info(re)
            partner = -1
            max_abd = 0.0
            sum_abd = 0.0
            for ll in left_all:
                le = self.i2e[self.u2e[ll]]
                ca = self._common_abd(gr.get_edge_info(le), re_info)
                sum_abd += ca
                if ca > max_abd:
                    max_abd = ca
                    partner = ll
            if partner < 0:
                continue
            e = self.ug.add_edge(partner, v)
            self.u2w[e] = max_abd
            self.econf[re] = math.log(max_abd / sum_abd) if sum_abd > 0 else 0.0

    # ------------------------------------------------------------------ build
    def build(self):
        """router.cc:193-223"""
        assert self.type in (UNSPLITTABLE_SINGLE, SPLITTABLE_PURE)
        self.thread()
        for k in list(self.pe2w):
            if self.pe2w[k] < self.cfg.min_guaranteed_edge_weight:
                self.pe2w[k] = self.cfg.min_guaranteed_edge_weight

    def thread(self):
        """router.cc:738-857"""
        self.pe2w = {}
        vw = self._balanced_weights_components()
        weight_sum = sum(vw)
        while True:
            if self._thread_leaf(vw):
                continue
            if not self._thread_turn(vw):
                break
        assert self.ug.num_edges() == 0
        weight_remain = sum(w for w in vw if w > 0)
        self.ratio = weight_remain / weight_sum if weight_sum > 0 else 0.0
        for e, conf in self.econf.items():
            self.gr.get_edge_info(e).confidence += conf

    def _balanced_weights_components(self):
        """Per-component sqrt balancing (router.cc:1248-1275)."""
        vv = self.ug.compute_connected_components()
        vw = [0.0] * len(self.u2e)
        l = self.gr.in_degree(self.root)
        for cc in vv:
            sum1 = sum2 = 0.0
            for i in cc:
                w = self.gr.get_edge_weight(self.i2e[self.u2e[i]])
                if i < l:
                    sum1 += w
                else:
                    sum2 += w
                vw[i] = w
            if sum1 <= 0 or sum2 <= 0:
                continue
            r1 = math.sqrt(sum2 / sum1)
            r2 = math.sqrt(sum1 / sum2)
            for i in cc:
                vw[i] *= r1 if i < l else r2
        return vw

    def _thread_leaf(self, vw):
        """router.cc:859-897"""
        for e in self.ug.edges():
            s, t = e.a, e.b
            if s >= t:
                s, t = t, s
            if vw[s] < -0.5 or vw[t] < -0.5:
                continue
            if self.ug.degree(s) == 1 and vw[s] <= vw[t]:
                key = (self.u2e[s], self.u2e[t])
                if key not in self.pe2w:
                    self.pe2w[key] = vw[s]
                self.ug.clear_vertex(s)
                vw[t] -= vw[s]
                vw[s] = -1
                return True
            if self.ug.degree(t) == 1 and vw[t] <= vw[s]:
                key = (self.u2e[s], self.u2e[t])
                if key not in self.pe2w:
                    self.pe2w[key] = vw[t]
                self.ug.clear_vertex(t)
                vw[s] -= vw[t]
                vw[t] = -1
                return True
        return False

    def _thread_turn(self, vw):
        """router.cc:899-936"""
        x = -1
        for k in range(len(vw)):
            if vw[k] < -0.5:
                continue
            if self.ug.degree(k) <= 1:
                continue
            if x != -1 and vw[k] > vw[x]:
                continue
            x = k
        if x == -1:
            return False
        incident = self.ug.out_edges(x)
        ssum = sum(self.u2w[e] for e in incident)
        for e in incident:
            t = e.neighbor(x)
            w = vw[x] * self.u2w[e] / ssum if ssum > 0 else 0.0
            key = (self.u2e[x], self.u2e[t]) if x < t else (self.u2e[t], self.u2e[x])
            if key not in self.pe2w:
                self.pe2w[key] = w
            vw[t] -= w
        vw[x] = -1
        self.ug.clear_vertex(x)
        return True

    # ------------------------------------------------- splittable (subsetsum)
    def split_plain_vertex(self):
        """Partition components into two balanced sides (router.cc:360-543).
        Kept for the splittable decomposition path and the mixed-vertex
        machinery; the main loop threads SPLITTABLE_PURE vertices instead."""
        self.eqns = []
        gr = self.gr
        root = self.root
        l = gr.in_degree(root)
        n = gr.degree(root)
        vw = []
        sum1 = sum2 = 0.0
        for i, ei in enumerate(self.u2e):
            w = gr.get_edge_weight(self.i2e[ei])
            if i < l:
                sum1 += w
            else:
                sum2 += w
            vw.append(w)
        r1 = 1.0 if sum1 > sum2 else (sum2 / sum1 if sum1 > 0 else 1.0)
        r2 = 1.0 if sum1 < sum2 else (sum1 / sum2 if sum2 > 0 else 1.0)
        for i in range(l):
            vw[i] *= r1
        for i in range(l, n):
            vw[i] *= r2
        vv = self.ug.compute_connected_components()
        ss, tt = [], []
        for i, comp in enumerate(vv):
            ww = 0.0
            for u in comp:
                ww += vw[u] if u < l else -vw[u]
            if ww >= 0:
                ss.append((int(ww), i))
            else:
                tt.append((int(-ww), i))

        eqn0 = Equation()
        for side in (ss, tt):
            for w, ci in side:
                comp = vv[ci]
                if len(comp) <= 1:
                    continue
                r = w / (sum1 * r1) if sum1 * r1 > 0 else 0.0
                if eqn0.e >= 0 and r >= eqn0.e:
                    continue
                eqn0.clear()
                eqn0.e = r
                for u in comp:
                    (eqn0.s if u < l else eqn0.t).append(self.u2e[u])

        eqn1 = Equation()
        if len(ss) >= 2 and len(tt) >= 2:
            sss = SubsetSum(ss, tt)
            sss.solve()
            eqn1.e = sss.eqn.e
            for ci in sss.eqn.s + sss.eqn.t:
                for u in vv[ci]:
                    (eqn1.s if u < l else eqn1.t).append(self.u2e[u])
            w1 = sum(vw[self.e2u[e]] for e in eqn1.s)
            w2 = sum(vw[self.e2u[e]] for e in eqn1.t)
            smax = max(sum1, sum2)
            eqn1.e = abs(w1 - w2) / smax if smax > 0 else 0.0

        if eqn0.e < -0.5 and eqn1.e < -0.5:
            return
        if eqn1.e < -0.5:
            eqn2 = eqn0
        elif eqn0.e < -0.5:
            eqn2 = eqn1
        elif eqn0.e > eqn1.e:
            eqn2 = eqn1
        else:
            eqn2 = eqn0
        s1 = set(eqn2.s)
        s2 = set(eqn2.t)
        eqn3 = Equation()
        for i in range(l):
            if self.u2e[i] not in s1:
                eqn3.s.append(self.u2e[i])
        for i in range(l, n):
            if self.u2e[i] not in s2:
                eqn3.t.append(self.u2e[i])
        if len(eqn3.s) == 0 or len(eqn3.t) == 0:
            return
        eqn2.e = self._compute_balance_ratio(eqn2)
        eqn3.e = eqn2.e
        self.eqns = [eqn2, eqn3]
        self.ratio = max(eqn2.e, eqn3.e)

    def _compute_balance_ratio(self, eqn):
        """router.cc:545-590"""
        gr = self.gr
        s1 = sum(gr.get_edge_weight(self.i2e[e]) for e in eqn.s)
        t1 = sum(gr.get_edge_weight(self.i2e[e]) for e in eqn.t)
        l = gr.in_degree(self.root)
        s2 = sum(gr.get_edge_weight(self.i2e[self.u2e[i]]) for i in range(l))
        t2 = sum(gr.get_edge_weight(self.i2e[self.u2e[i]])
                 for i in range(l, gr.degree(self.root)))
        s2 -= s1
        t2 -= t1
        s1, s2 = math.log(1 + s1), math.log(1 + s2)
        t1, t2 = math.log(1 + t1), math.log(1 + t2)
        r1 = t1 / s1 if s1 < t1 else s1 / t1
        r2 = t2 / s2 if s2 < t2 else s2 / t2
        return max(r1, r2)
