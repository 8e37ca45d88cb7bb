"""Phasing paths over the splice graph ("hyper edges").

Re-implements scallop/hyper_set.{h,cc}: node lists built from phase-set
coordinates, edge lists for paths with count >= 2 fully mappable onto graph
edges, an edge -> hyper-edge index, successor/predecessor/route queries used
by the router, and the surgical replace/remove/insert operations mirroring
the decomposition's edge splits.  Edge lists may contain -1 separators.
"""

from __future__ import annotations

from ..core.essential import build_path_from_exon_coordinates, check_valid_path
from ..utils.seqs import consecutive_subset


class HyperSet:
    def __init__(self, gr=None, ps=None):
        self.nodes = {}     # tuple(vertex list) -> count
        self.edges = []     # list of edge-index lists (-1 = broken link)
        self.ecnts = []
        self.e2s = {}       # edge index -> set of hyper-edge ids
        if gr is not None and ps is not None:
            for v, c in ps.pmap.items():
                ok, vv = build_path_from_exon_coordinates(gr, list(v))
                if not ok:
                    continue
                self.add_node_list(vv, c, 0)

    # ------------------------------------------------------------- node lists
    def add_node_list(self, s, c, o=0):
        v = tuple(sorted(x + o for x in s))
        self.nodes[v] = self.nodes.get(v, 0) + c

    def filter_nodes(self, gr):
        """Keep only valid multi-vertex paths (hyper_set.cc:356-371)."""
        mv = {}
        for vv, c in self.nodes.items():
            if len(vv) <= 1:
                continue
            if not check_valid_path(gr, list(vv)):
                continue
            mv[vv] = c
        self.nodes = mv

    # ------------------------------------------------------------ edge lists
    def build(self, gr, e2i):
        self.build_edges(gr, e2i)
        self.build_index()

    def build_edges(self, gr, e2i):
        """hyper_set.cc:323-354"""
        self.edges = []
        self.ecnts = []
        for vv in sorted(self.nodes.keys()):
            c = self.nodes[vv]
            if c <= 1:
                continue
            if len(vv) <= 1:
                continue
            ve = []
            ok = True
            for k in range(len(vv) - 1):
                e = gr.edge(vv[k], vv[k + 1])
                if e is None:
                    ok = False
                    ve.append(-1)
                else:
                    ve.append(e2i[e])
            if ok and len(ve) >= 2:
                self.edges.append(ve)
                self.ecnts.append(c)

    def build_index(self):
        """hyper_set.cc:436-459"""
        self.e2s = {}
        for i, v in enumerate(self.edges):
            for e in v:
                if e == -1:
                    continue
                self.e2s.setdefault(e, set()).add(i)

    # --------------------------------------------------------------- queries
    def get_intersection(self, v):
        """hyper_set.cc:489-507"""
        if len(v) == 0:
            return set()
        ss = self.e2s.get(v[0])
        if ss is None:
            return set()
        ss = set(ss)
        for e in v[1:]:
            s = self.e2s.get(e)
            if s is None:
                return set()
            ss &= s
        return ss

    def get_successors(self, e):
        """hyper_set.cc:509-529; hyper-edge ids visited in sorted order so
        the successor-key order (which feeds the router's route order) is
        canonical rather than set-iteration order."""
        s = {}
        for k in sorted(self.e2s.get(e, ())):
            v = self.edges[k]
            c = self.ecnts[k]
            for i in range(len(v) - 1):
                if v[i] != e:
                    continue
                nxt = v[i + 1]
                if nxt == -1:
                    continue
                s[nxt] = s.get(nxt, 0) + c
        return s

    def get_predecessors(self, e):
        """hyper_set.cc:531-551; sorted visit order, as get_successors."""
        s = {}
        for k in sorted(self.e2s.get(e, ())):
            v = self.edges[k]
            c = self.ecnts[k]
            for i in range(1, len(v)):
                if v[i] != e:
                    continue
                prv = v[i - 1]
                if prv == -1:
                    continue
                s[prv] = s.get(prv, 0) + c
        return s

    def get_routes(self, x, gr, e2i):
        """(in-edge, out-edge) -> count through vertex x (hyper_set.cc:553-571)."""
        mpi = {}
        for ein in gr.in_edges(x):
            e = e2i[ein]
            for k, c in self.get_successors(e).items():
                mpi[(e, k)] = c
        return mpi

    # -------------------------------------------------------------- surgery
    def replace_list(self, v, e):
        """Replace consecutive run v by e (hyper_set.cc:626-675)."""
        if len(v) == 0:
            return
        s = self.get_intersection(v)
        fb = []
        for k in sorted(s):
            vv = self.edges[k]
            bv = consecutive_subset(vv, v)
            if len(bv) <= 0:
                continue
            for b in sorted(bv, reverse=True):
                vv[b] = e
                del vv[b + 1:b + len(v)]
            fb.append(k)
            self.e2s.setdefault(e, set()).add(k)
        if len(v) != 1:
            return
        for u in v:
            if u not in self.e2s:
                continue
            for k in fb:
                self.e2s[u].discard(k)
            if len(self.e2s[u]) == 0:
                del self.e2s[u]

    def replace(self, x, e):
        self.replace_list([x], e)

    def replace_pair(self, x, y, e):
        self.replace_list([x, y], e)

    def replace_pair2(self, x, y, x2, y2):
        """hyper_set.cc:677-723"""
        s = self.get_intersection([x, y])
        for k in sorted(s):
            vv = self.edges[k]
            f = False
            for i in range(len(vv) - 1):
                if vv[i] == x and vv[i + 1] == y:
                    vv[i] = x2
                    vv[i + 1] = y2
                    f = True
                    break
            if not f:
                continue
            self.e2s.setdefault(y2, set()).add(k)
            self.e2s.setdefault(x2, set()).add(k)

    def remove(self, e):
        """hyper_set.cc:787-818"""
        if e not in self.e2s:
            return
        s = self.e2s[e]
        for k in s:
            vv = self.edges[k]
            for i in range(len(vv)):
                if vv[i] == e:
                    vv[i] = -1
        del self.e2s[e]

    def remove_pair(self, x, y):
        """hyper_set.cc:820-824 — break the link between x and y."""
        self.insert_between(x, y, -1)

    def insert_between(self, x, y, e):
        """hyper_set.cc:865-902"""
        if x not in self.e2s:
            return
        for k in sorted(self.e2s[x]):
            vv = self.edges[k]
            i = 0
            while i < len(vv) - 1:
                if vv[i] == x and vv[i + 1] == y:
                    vv.insert(i + 1, e)
                    if e != -1:
                        self.e2s.setdefault(e, set()).add(k)
                    i += 1   # skip over inserted element
                i += 1

    def right_break(self, x):
        """hyper_set.cc:904-922"""
        if x not in self.e2s:
            return
        for k in sorted(self.e2s[x]):
            vv = self.edges[k]
            for i in range(len(vv) - 1):
                if vv[i] == x:
                    vv.insert(i + 1, -1)
                    break

    def left_break(self, x):
        """hyper_set.cc:924-942"""
        if x not in self.e2s:
            return
        for k in sorted(self.e2s[x]):
            vv = self.edges[k]
            for i in range(1, len(vv)):
                if vv[i] == x:
                    vv.insert(i, -1)
                    break

    # ------------------------------------------------------------- predicates
    def left_extend(self, e):
        """hyper_set.cc:949-965"""
        for k in self.e2s.get(e, ()):
            vv = self.edges[k]
            for i in range(1, len(vv)):
                if vv[i] == e and vv[i - 1] != -1:
                    return True
        return False

    def right_extend(self, e):
        """hyper_set.cc:967-983"""
        for k in self.e2s.get(e, ()):
            vv = self.edges[k]
            for i in range(len(vv) - 1):
                if vv[i] == e and vv[i + 1] != -1:
                    return True
        return False

    def left_extend_any(self, es):
        return any(self.left_extend(e) for e in es)

    def right_extend_any(self, es):
        return any(self.right_extend(e) for e in es)

    def left_dominate(self, e):
        """Every right-extended appearance also extends left
        (hyper_set.cc:1003-1042)."""
        if e not in self.e2s:
            return True
        x1 = set()
        x2 = set()
        for k in self.e2s[e]:
            vv = self.edges[k]
            for i in range(len(vv) - 1):
                if vv[i] != e or vv[i + 1] == -1:
                    continue
                if i == 0 or vv[i - 1] == -1:
                    if i + 2 < len(vv):
                        x1.add((vv[i + 1], vv[i + 2]))
                    else:
                        x1.add((vv[i + 1], -1))
                else:
                    x2.add((vv[i + 1], -1))
                    if i + 2 < len(vv):
                        x2.add((vv[i + 1], vv[i + 2]))
        return x1 <= x2

    def right_dominate(self, e):
        """hyper_set.cc:1044-1082"""
        if e not in self.e2s:
            return True
        x1 = set()
        x2 = set()
        for k in self.e2s[e]:
            vv = self.edges[k]
            for i in range(1, len(vv)):
                if vv[i] != e or vv[i - 1] == -1:
                    continue
                if i == len(vv) - 1 or vv[i + 1] == -1:
                    if i - 2 >= 0:
                        x1.add((vv[i - 1], vv[i - 2]))
                    else:
                        x1.add((vv[i - 1], -1))
                else:
                    x2.add((vv[i - 1], -1))
                    if i - 2 >= 0:
                        x2.add((vv[i - 1], vv[i - 2]))
        return x1 <= x2
