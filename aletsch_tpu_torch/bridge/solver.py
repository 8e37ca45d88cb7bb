"""Paired-end bridging: bounded bottleneck DP over the splice graph.

Re-implements bridge/bridge_solver.{h,cc}: temporary weight-0.5 adjacent
edges let the DP cross coverage gaps; per unique (source, target) vertex pair
("pier") a DP over vertex order keeps the top ``bridge_dp_solution_size``
entries per vertex ranked by a ``bridge_dp_stack_size``-deep ascending stack
of the smallest edge weights along the path (lexicographic bottleneck
comparison, bridge_solver.cc:21-30, 484-546); per cluster, candidate whole
chains are validated for monotonicity, strand consistency, and fragment
length within the sample insert-size window (vote, :287-385).

The batched TPU variant of the same DP lives in ops/bridge_dp.py; this module
is the reference host path and handles the irregular graph surgery around it.
"""

from __future__ import annotations

from ..utils.seqs import check_increasing, merge_intron_chains
from .solver_types import BridgePath
from ..core.essential import (build_intron_coordinates_from_path,
                              check_continuous_vertices,
                              check_strand_from_intron_coordinates,
                              get_total_length_of_introns)


class _Entry:
    __slots__ = ("stack", "length", "trace1", "trace2")

    def __init__(self, stack, length, t1, t2):
        self.stack = stack
        self.length = length
        self.trace1 = t1
        self.trace2 = t2

    def sort_key(self):
        # entry_compare: larger stack lexicographically first, then shorter
        return (tuple(-x for x in self.stack), self.length)


def _update_stack(v, s):
    """Insert s into ascending stack v, keep len(v) smallest
    (bridge_solver.cc:532-546)."""
    n = len(v)
    stack = [0] * n
    i = j = 0
    while i < n and j < n:
        if i == j and v[i] > s:
            stack[j] = s
            j += 1
            if j >= n:
                break
        stack[j] = v[i]
        i += 1
        j += 1
    return stack


class BridgeSolver:
    def __init__(self, gr, vc, cfg, length_low, length_high):
        self.gr = gr
        self.vc = vc
        self.cfg = cfg
        self.length_low = length_low
        self.length_high = length_high
        self.opt = []
        self._adjedges = []
        self._pseudos = set()
        self.piers = []        # list of [bs, bt, bridges]
        self.vpairs = []

        self._add_adjacent_edges()
        self._build_pseudo_introns()
        self._build_bridging_vertices()
        self._build_piers()
        self._nominate()
        self._vote_all()
        self._remove_adjacent_edges()

    # ------------------------------------------------------- setup / teardown
    def _add_adjacent_edges(self):
        """bridge_solver.cc:71-95"""
        gr = self.gr
        for i in range(1, gr.num_vertices() - 2):
            if gr.edge(i, i + 1) is not None:
                continue
            e = gr.add_edge(i, i + 1)
            gr.set_edge_weight(e, 0.5)
            gr.get_edge_info(e).weight = 0.5
            self._adjedges.append(e)

    def _remove_adjacent_edges(self):
        for e in self._adjedges:
            self.gr.remove_edge(e)

    def _build_pseudo_introns(self):
        """bridge_solver.cc:97-108"""
        for e in self._adjedges:
            p1 = self.gr.get_vertex_info(e.s).rpos
            p2 = self.gr.get_vertex_info(e.t).lpos
            if p1 >= p2:
                continue
            self._pseudos.add((p1, p2))

    def _filter_pseudo_introns(self, chain):
        """bridge_solver.cc:110-122"""
        v = []
        for k in range(len(chain) // 2):
            p = (chain[k * 2], chain[k * 2 + 1])
            if p in self._pseudos:
                continue
            v.extend(p)
        return v

    # ----------------------------------------------------- bridging vertices
    def _build_bridging_vertices(self):
        """bridge_solver.cc:53-69"""
        gr = self.gr
        self.vpairs = []
        for pc in self.vc:
            v1 = gr.locate_vertex(pc.bounds[1] - 1)
            v2 = gr.locate_vertex(pc.bounds[2])
            if self._check_left_relaxing(pc, v1):
                v1 -= 1
            if self._check_right_relaxing(pc, v2):
                v2 += 1
            self.vpairs.append((v1, v2))

    def _check_left_relaxing(self, pc, v):
        """bridge_solver.cc:124-135"""
        gr = self.gr
        n = gr.num_vertices() - 1
        if v <= 0 or v >= n:
            return False
        p = gr.get_vertex_info(v).lpos
        if v <= 1:
            return False
        if not check_continuous_vertices(gr, v - 1, v):
            return False
        if pc.bounds[1] - p > self.cfg.bridge_end_relaxing:
            return False
        if len(pc.chain1) >= 1 and pc.chain1[-1] >= p:
            return False
        return True

    def _check_right_relaxing(self, pc, v):
        """bridge_solver.cc:137-148"""
        gr = self.gr
        n = gr.num_vertices() - 1
        if v <= 0 or v >= n:
            return False
        p = gr.get_vertex_info(v).rpos
        if v >= n - 1:
            return False
        if not check_continuous_vertices(gr, v, v + 1):
            return False
        if p - pc.bounds[2] > self.cfg.bridge_end_relaxing:
            return False
        if len(pc.chain2) >= 1 and pc.chain2[0] <= p:
            return False
        return True

    def _build_piers(self):
        """bridge_solver.cc:150-167"""
        self.piers = []
        ss = set()
        for p in self.vpairs:
            if p[0] < 0 or p[1] < 0 or p[0] >= p[1]:
                continue
            if p in ss:
                continue
            ss.add(p)
            self.piers.append([p[0], p[1], []])

    # -------------------------------------------------------------------- DP
    def _nominate(self):
        """bridge_solver.cc:180-257"""
        if len(self.piers) == 0:
            return
        self.piers.sort(key=lambda x: (x[0], x[1]))
        bounds = self._build_bounds()
        strand = self.gr.strand
        if strand == ".":
            strands = (1, 2)
        elif strand == "+":
            strands = (1,)
        else:
            strands = (2,)
        for st in strands:
            for b1, b2 in bounds:
                k1 = self.piers[b2][0]
                k2 = self.piers[b2][1]
                table = self._dynamic_programming(k1, k2, st)
                for b in range(b1, b2 + 1):
                    bt = self.piers[b][1]
                    for j, path_v in enumerate(self._trace_back(bt, table)):
                        p = BridgePath()
                        p.score = table[bt][j].stack[0]
                        p.stack = list(table[bt][j].stack)
                        p.v = path_v
                        chain = build_intron_coordinates_from_path(self.gr, p.v)
                        p.chain = self._filter_pseudo_introns(chain)
                        self.piers[b][2].append(p)
        for pr in self.piers:
            self._refine_pier(pr)

    def _build_bounds(self):
        """Runs of piers sharing the same source (bridge_solver.cc:205-222)."""
        bounds = []
        b1 = 0
        for i in range(1, len(self.piers)):
            if self.piers[i][0] != self.piers[i - 1][0]:
                bounds.append((b1, i - 1))
                b1 = i
        bounds.append((b1, len(self.piers) - 1))
        return bounds

    def _dynamic_programming(self, k1, k2, strand):
        """bridge_solver.cc:484-530"""
        gr = self.gr
        cfg = self.cfg
        n = gr.num_vertices()
        table = [[] for _ in range(n)]
        vi = gr.get_vertex_info(k1)
        table[k1] = [_Entry([999999] * cfg.bridge_dp_stack_size,
                            vi.rpos - vi.lpos, -1, -1)]
        for k in range(k1 + 1, k2 + 1):
            v = []
            vk = gr.get_vertex_info(k)
            length = vk.rpos - vk.lpos
            for e in gr.in_edges(k):
                s = gr.get_edge_info(e).strand
                if s != 0 and s != strand:
                    continue
                j = e.s
                if j < k1 or len(table[j]) == 0:
                    continue
                w = int(gr.get_edge_weight(e))
                for i, ent in enumerate(table[j]):
                    v.append(_Entry(_update_stack(ent.stack, w),
                                    ent.length + length, j, i))
            v.sort(key=_Entry.sort_key)
            if len(v) > cfg.bridge_dp_solution_size:
                v = v[:cfg.bridge_dp_solution_size]
            table[k] = v
        return table

    def _trace_back(self, k, table):
        """bridge_solver.cc:548-568"""
        vv = []
        for i in range(len(table[k])):
            v = []
            p, q = k, i
            while True:
                v.append(p)
                e = table[p][q]
                p, q = e.trace1, e.trace2
                if p < 0:
                    break
            v.reverse()
            vv.append(v)
        return vv

    def _refine_pier(self, pr):
        """Dedup same-vertex-list bridges, rank by stack
        (bridge_solver.cc:259-274)."""
        if len(pr[2]) == 0:
            return
        pr[2].sort(key=lambda p: (p.v, len(p.v)))
        v = [pr[2][0]]
        for p in pr[2][1:]:
            if p.v == v[-1].v:
                continue
            v.append(p)
        v.sort(key=lambda p: ([-x for x in p.stack], -len(p.stack)))
        pr[2] = v

    # ------------------------------------------------------------------ vote
    def _vote_all(self):
        """bridge_solver.cc:276-285"""
        pindex = {(pr[0], pr[1]): i for i, pr in enumerate(self.piers)}
        self.opt = []
        for i in range(len(self.vc)):
            self.opt.append(self._vote(i, pindex))

    def _vote(self, r, pindex):
        """bridge_solver.cc:287-385"""
        bbp = BridgePath()
        bbp.type = -1
        ss, tt = self.vpairs[r]
        if ss < 0 or tt < 0:
            return bbp
        pc = self.vc[r]
        gr = self.gr

        chains = []
        wholes = []
        scores = []
        strands = []
        typ = 0
        if ss >= tt:
            ok, w = merge_intron_chains(pc.chain1, pc.chain2)
            if not ok or not check_increasing(w):
                return bbp
            s = check_strand_from_intron_coordinates(gr, w)
            if s < 0:
                return bbp
            typ = 1
            chains.append([])
            wholes.append(w)
            scores.append(10)
            strands.append(s)
        elif (ss, tt) in pindex:
            typ = 2
            for pb in self.piers[pindex[(ss, tt)]][2]:
                w = list(pc.chain1) + list(pb.chain) + list(pc.chain2)
                if not check_increasing(w):
                    continue
                s = check_strand_from_intron_coordinates(gr, w)
                if s < 0:
                    continue
                wholes.append(w)
                chains.append(pb.chain)
                scores.append(pb.score)
                strands.append(s)

        if len(chains) == 0:
            return bbp

        be = -1
        choices = 0
        for e in range(len(chains)):
            if len(wholes[e]) >= 1 and wholes[e][0] <= pc.bounds[0]:
                continue
            if len(wholes[e]) >= 1 and wholes[e][-1] >= pc.bounds[3]:
                continue
            intron = get_total_length_of_introns(wholes[e])
            length = pc.bounds[3] - pc.bounds[0] - intron
            if length < self.length_low or length > self.length_high:
                continue
            if strands[e] < 0:
                continue
            if be < 0:
                be = e
            choices += 1

        if be < 0:
            return bbp
        bbp.type = typ
        bbp.score = scores[be]
        bbp.chain = chains[be]
        bbp.whole = wholes[be]
        bbp.strand = strands[be]
        bbp.choices = choices
        return bbp
