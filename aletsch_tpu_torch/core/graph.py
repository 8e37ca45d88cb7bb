"""Splice graph: weighted DAG over partial exons.

Re-expresses the reference's pointer-based splice_graph
(rnacore/splice_graph.{h,cc}, graph/directed_graph.{h,cc}) with explicit Edge
objects and insertion-ordered adjacency (deterministic iteration, unlike the
reference's pointer-ordered std::set).  Vertex 0 is the source, vertex n-1 the
sink; interior vertex i covers genomic interval [lpos, rpos).

Supports parallel edges (required by the decomposition's split_edge), edge
moves (vertex splitting), topological sort (Kahn, vertex-id tie order matching
directed_graph.cc:420-451), the bottleneck max-path DP
(splice_graph.cc:819-885) and position->vertex indices.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field, replace

from ..constants import END_BOUNDARY, LEFT_MIXED, LEFT_SPLICE, MIDDLE_CUT, \
    RIGHT_MIXED, RIGHT_SPLICE, START_BOUNDARY

INF = float("inf")


@dataclass
class VertexInfo:
    lpos: int = 0
    rpos: int = 0
    stddev: float = 1.0
    maxcov: float = 0.0
    length: int = 0
    type: int = 0
    regional: bool = False
    boundary_loss1: float = 0.0
    boundary_loss2: float = 0.0
    boundary_loss3: float = 0.0
    boundary_merged_loss: float = 0.0
    unbridge_leaving_count: int = 0
    unbridge_leaving_ratio: float = 0.0
    unbridge_coming_count: int = 0
    unbridge_coming_ratio: float = 0.0

    def copy(self):
        return replace(self)


@dataclass
class EdgeInfo:
    weight: float = 0.0
    strand: int = 0          # 0 unknown, 1 '+', 2 '-'
    length: int = 0
    count: int = 0           # number of supporting samples
    abd: float = 0.0
    confidence: float = 0.0
    samples: set = field(default_factory=set)
    spAbd: dict = field(default_factory=dict)

    def copy(self):
        return EdgeInfo(self.weight, self.strand, self.length, self.count,
                        self.abd, self.confidence, set(self.samples),
                        dict(self.spAbd))


class Edge:
    __slots__ = ("s", "t", "eid")

    def __init__(self, s, t, eid):
        self.s = s
        self.t = t
        self.eid = eid

    def source(self):
        return self.s

    def target(self):
        return self.t

    def __repr__(self):
        return "E%d(%d->%d)" % (self.eid, self.s, self.t)


class SpliceGraph:
    def __init__(self):
        self.chrm = ""
        self.strand = "."
        self.gid = ""
        self.reads = 0
        self.subgraph = 1
        self._next_eid = 0
        self.vinfo = []            # VertexInfo per vertex
        self.vwrt = []             # vertex weights
        self._in = []              # per-vertex ordered dict Edge -> None
        self._out = []
        self.ewrt = {}             # Edge -> weight
        self.einfo = {}            # Edge -> EdgeInfo
        self.lindex = {}           # lpos -> vertex
        self.rindex = {}           # rpos -> vertex

    # ------------------------------------------------------------- structure
    def add_vertex(self) -> int:
        self.vinfo.append(VertexInfo())
        self.vwrt.append(0.0)
        self._in.append({})
        self._out.append({})
        return len(self.vinfo) - 1

    def num_vertices(self):
        return len(self.vinfo)

    def num_edges(self):
        return len(self.ewrt)

    def add_edge(self, s, t) -> Edge:
        e = Edge(s, t, self._next_eid)
        self._next_eid += 1
        self._out[s][e] = None
        self._in[t][e] = None
        self.ewrt[e] = 0.0
        self.einfo[e] = EdgeInfo()
        return e

    def remove_edge(self, e: Edge):
        del self._out[e.s][e]
        del self._in[e.t][e]
        del self.ewrt[e]
        self.einfo.pop(e, None)

    def move_edge(self, e: Edge, s, t):
        """Re-anchor an edge (directed_graph::move_edge)."""
        del self._out[e.s][e]
        del self._in[e.t][e]
        e.s = s
        e.t = t
        self._out[s][e] = None
        self._in[t][e] = None

    def clear_vertex(self, v):
        for e in list(self._in[v]) + list(self._out[v]):
            self.remove_edge(e)

    def edge(self, s, t):
        """First edge s->t or None (directed_graph::edge)."""
        for e in self._out[s]:
            if e.t == t:
                return e
        return None

    def edges(self):
        """All edges in deterministic (creation) order."""
        return sorted(self.ewrt.keys(), key=lambda e: e.eid)

    def in_edges(self, v):
        return list(self._in[v])

    def out_edges(self, v):
        return list(self._out[v])

    def in_degree(self, v):
        return len(self._in[v])

    def out_degree(self, v):
        return len(self._out[v])

    def degree(self, v):
        return len(self._in[v]) + len(self._out[v])

    # --------------------------------------------------------------- weights
    def get_vertex_weight(self, v):
        return self.vwrt[v]

    def set_vertex_weight(self, v, w):
        self.vwrt[v] = w

    def get_vertex_info(self, v) -> VertexInfo:
        return self.vinfo[v]

    def set_vertex_info(self, v, vi):
        self.vinfo[v] = vi

    def get_edge_weight(self, e):
        return self.ewrt[e]

    def set_edge_weight(self, e, w):
        self.ewrt[e] = w

    def get_edge_info(self, e) -> EdgeInfo:
        return self.einfo[e]

    def set_edge_info(self, e, ei):
        self.einfo[e] = ei

    def get_in_weights(self, v):
        return sum(self.ewrt[e] for e in self._in[v])

    def get_out_weights(self, v):
        return sum(self.ewrt[e] for e in self._out[v])

    def get_max_in_weight(self, v):
        return max((self.ewrt[e] for e in self._in[v]), default=0.0)

    def get_max_out_weight(self, v):
        return max((self.ewrt[e] for e in self._out[v]), default=0.0)

    def min_in_edge(self, v):
        return min(self._in[v], key=lambda e: (self.ewrt[e], e.eid), default=None)

    def min_out_edge(self, v):
        return min(self._out[v], key=lambda e: (self.ewrt[e], e.eid), default=None)

    def max_in_edge(self, v):
        return max(self._in[v], key=lambda e: (self.ewrt[e], -e.eid), default=None)

    def max_out_edge(self, v):
        return max(self._out[v], key=lambda e: (self.ewrt[e], -e.eid), default=None)

    # ------------------------------------------------------------------ copy
    def copy(self) -> "SpliceGraph":
        g = SpliceGraph()
        g.chrm = self.chrm
        g.strand = self.strand
        g.gid = self.gid
        g.reads = self.reads
        g.subgraph = self.subgraph
        for v in range(self.num_vertices()):
            g.add_vertex()
            g.vwrt[v] = self.vwrt[v]
            g.vinfo[v] = self.vinfo[v].copy()
        for e in self.edges():
            f = g.add_edge(e.s, e.t)
            g.ewrt[f] = self.ewrt[e]
            g.einfo[f] = self.einfo[e].copy()
        g.lindex = dict(self.lindex)
        g.rindex = dict(self.rindex)
        return g

    # --------------------------------------------------------------- indices
    def build_vertex_index(self):
        """pos -> vertex maps (splice_graph.cc:1087-1099)."""
        self.lindex = {}
        self.rindex = {}
        n = self.num_vertices() - 1
        for i in range(n + 1):
            v = self.vinfo[i]
            if i != 0:
                self.lindex[v.lpos] = i
            if i != n:
                self.rindex[v.rpos] = i
        # sorted interior lpos list for C-speed vertex location; valid only
        # on positional graphs (pre-decomposition), like the reference's
        # binary search
        self._llist = [self.vinfo[i].lpos for i in range(1, n)]

    def locate_vertex(self, p):
        """Interior vertex covering position p, or -1 (splice_graph.cc:1166)."""
        ll = getattr(self, "_llist", None)
        if ll is not None and len(ll) == self.num_vertices() - 2:
            i = bisect_right(ll, p)
            if i == 0:
                return -1
            v = self.vinfo[i]
            return i if v.lpos <= p < v.rpos else -1
        m = self._locate(p, 1, self.num_vertices() - 1)
        if m >= self.num_vertices():
            return -1
        v = self.vinfo[m]
        if v.lpos <= p < v.rpos:
            return m
        return -1

    def _locate(self, p, a, b):
        while a < b:
            m = (a + b) // 2
            v = self.vinfo[m]
            if v.lpos <= p < v.rpos:
                return m
            if p < v.lpos:
                b = m
            else:
                a = m + 1
        return b

    def locate_lbound(self, p):
        return self.lindex.get(p, -1)

    def locate_rbound(self, p):
        return self.rindex.get(p, -1)

    # ------------------------------------------------------------------ DAGs
    def topological_sort(self):
        """Kahn's algorithm in vertex-id order (directed_graph.cc:420-451)."""
        n = self.num_vertices()
        vd = [self.in_degree(i) for i in range(n)]
        q = [i for i in range(n) if vd[i] == 0]
        v = []
        k = 0
        while k < len(q):
            x = q[k]
            k += 1
            v.append(x)
            for e in self._out[x]:
                vd[e.t] -= 1
                if vd[e.t] == 0:
                    q.append(e.t)
        return v

    def compute_maximum_path_w(self):
        return self.compute_maximum_st_path_w(0, self.num_vertices() - 1)

    def compute_maximum_st_path_w(self, ss, tt):
        """Bottleneck max path DP over topological order
        (splice_graph.cc:819-885).  Returns (weight, [edges]); weight -1 if
        unreachable."""
        n = self.num_vertices()
        table = [-1.0] * n
        back = [None] * n
        tp = self.topological_sort()
        pos = {v: i for i, v in enumerate(tp)}
        ssi, tti = pos[ss], pos[tt]
        table[ss] = INF
        for ii in range(ssi + 1, tti + 1):
            i = tp[ii]
            if self.degree(i) == 0:
                continue
            max_abd = 0.0
            max_edge = None
            for e in self._in[i]:
                s = e.s
                if table[s] <= -1:
                    continue
                xw = self.ewrt[e]
                ww = min(xw, table[s])
                if ww >= max_abd:
                    max_abd = ww
                    max_edge = e
            if max_edge is None:
                continue
            back[i] = max_edge
            table[i] = max_abd
        p = []
        x = tt
        while True:
            e = back[x]
            if e is None:
                break
            p.append(e)
            x = e.s
        p.reverse()
        return table[tt], p

    def compute_num_paths(self):
        """Number of source->sink paths (used only for classification)."""
        n = self.num_vertices()
        cnt = [0] * n
        cnt[0] = 1
        for v in self.topological_sort():
            for e in self._out[v]:
                cnt[e.t] += cnt[v]
                cnt[e.t] = min(cnt[e.t], 1 << 60)
        return cnt[n - 1]

    # --------------------------------------------------------------- strands
    def get_strand_degree(self, i):
        """[in0,in+,in-,out0,out+,out-] (splice_graph.cc:1384-1406)."""
        vs = [0] * 6
        for e in self._in[i]:
            vs[self.einfo[e].strand] += 1
        for e in self._out[i]:
            vs[self.einfo[e].strand + 3] += 1
        return vs

    def mixed_strand_vertex(self, i):
        v = self.get_strand_degree(i)
        return (v[1] + v[4]) >= 1 and (v[2] + v[5]) >= 1

    def mixed_strand_graph(self):
        p = q = False
        for e in self.ewrt:
            s = self.einfo[e].strand
            if s == 1:
                p = True
            if s == 2:
                q = True
        return p and q

    def extend_strands(self):
        """Propagate junction strands onto bridging adjacent edges
        (splice_graph.cc:1338-1373)."""
        for e in self.edges():
            sd = self.einfo[e].strand
            s, t = e.s, e.t
            p1 = self.vinfo[s].rpos
            p2 = self.vinfo[t].lpos
            if p1 >= p2:
                continue
            if s + 2 != t:
                continue
            we = self.ewrt[e]
            wv = self.vwrt[s + 1]
            if we <= wv:
                continue
            if self.vinfo[s + 1].lpos != p1 or self.vinfo[s + 1].rpos != p2:
                continue
            e1 = self.edge(s, s + 1)
            e2 = self.edge(s + 1, t)
            if e1 is not None and self.einfo[e1].strand == 0:
                self.einfo[e1].strand = sd
            if e2 is not None and self.einfo[e2].strand == 0:
                self.einfo[e2].strand = sd

    # ----------------------------------------------------------- annotations
    def determine_position_left_type(self, p):
        """splice_graph.cc:1128-1152"""
        if p not in self.lindex:
            return -1
        x = self.lindex[p]
        if self.edge(0, x) is not None:
            return START_BOUNDARY
        splice = adjacent = False
        vx = self.vinfo[x]
        for e in self._in[x]:
            vi = self.vinfo[e.s]
            if vi.rpos == vx.lpos:
                adjacent = True
            if vi.rpos < vx.lpos:
                splice = True
        if splice and adjacent:
            return LEFT_MIXED
        if splice:
            return LEFT_SPLICE
        if adjacent and self._right_type_raw(p) == RIGHT_MIXED:
            return RIGHT_MIXED
        return MIDDLE_CUT

    def determine_position_right_type(self, p):
        """splice_graph.cc:1101-1126"""
        if p not in self.rindex:
            return -1
        x = self.rindex[p]
        n = self.num_vertices() - 1
        if self.edge(x, n) is not None:
            return END_BOUNDARY
        splice = adjacent = False
        vx = self.vinfo[x]
        for e in self._out[x]:
            vi = self.vinfo[e.t]
            if vi.lpos == vx.rpos:
                adjacent = True
            if vi.lpos > vx.rpos:
                splice = True
        if splice and adjacent:
            return RIGHT_MIXED
        if splice:
            return RIGHT_SPLICE
        if adjacent and self._left_type_raw(p) == LEFT_MIXED:
            return LEFT_MIXED
        return MIDDLE_CUT

    def _left_type_raw(self, p):
        if p not in self.lindex:
            return -1
        x = self.lindex[p]
        if self.edge(0, x) is not None:
            return START_BOUNDARY
        splice = adjacent = False
        vx = self.vinfo[x]
        for e in self._in[x]:
            vi = self.vinfo[e.s]
            if vi.rpos == vx.lpos:
                adjacent = True
            if vi.rpos < vx.lpos:
                splice = True
        if splice and adjacent:
            return LEFT_MIXED
        if splice:
            return LEFT_SPLICE
        return MIDDLE_CUT

    def _right_type_raw(self, p):
        if p not in self.rindex:
            return -1
        x = self.rindex[p]
        if self.edge(x, self.num_vertices() - 1) is not None:
            return END_BOUNDARY
        splice = adjacent = False
        vx = self.vinfo[x]
        for e in self._out[x]:
            vi = self.vinfo[e.t]
            if vi.lpos == vx.rpos:
                adjacent = True
            if vi.lpos > vx.rpos:
                splice = True
        if splice and adjacent:
            return RIGHT_MIXED
        if splice:
            return RIGHT_SPLICE
        return MIDDLE_CUT
