"""Dedup stores for intron chains and phasing paths.

ChainSet mirrors rnacore/chain_set.{h,cc}: chains keyed by their first
coordinate, per-chain strand-support counters [xs='.', '+', '-'], and a
hit-id handle map so chains can be decremented when hits are eliminated.

PhaseSet mirrors rnacore/phase_set.{h,cc}: full coordinate paths
[start, i1l, i1r, ..., end] -> read counts.
"""

from __future__ import annotations

from ..utils.seqs import check_increasing

_XS_IDX = {".": 0, "+": 1, "-": 2}


class ChainSet:
    def __init__(self):
        self.pmap = {}    # first coord -> group index
        self.chains = []  # group -> list of [chain tuple, [c0,c+,c-]]
        self.hmap = {}    # hit id -> (group, idx, xs-index)

    def add_counts(self, v, counts):
        """Merge a chain with explicit counters (chain_set.cc:24-62)."""
        if len(v) <= 0:
            return
        v = tuple(v)
        p = v[0]
        k = self.pmap.get(p)
        if k is None:
            self.chains.append([[v, list(counts)]])
            self.pmap[p] = len(self.chains) - 1
            return
        for item in self.chains[k]:
            if item[0] == v:
                item[1][0] += counts[0]
                item[1][1] += counts[1]
                item[1][2] += counts[2]
                return
        self.chains[k].append([v, list(counts)])

    def add(self, v, h, xs_char):
        """Add a chain supported by hit h with strand char (chain_set.cc:64-123)."""
        if len(v) <= 0:
            return
        if h >= 0 and h in self.hmap:
            return
        v = tuple(v)
        xs = _XS_IDX.get(xs_char, 0)
        p = v[0]
        k = self.pmap.get(p)
        if k is None:
            c = [0, 0, 0]
            c[xs] = 1
            self.chains.append([[v, c]])
            k = len(self.chains) - 1
            self.pmap[p] = k
            if h >= 0:
                self.hmap[h] = (k, 0, xs)
            return
        group = self.chains[k]
        for i, item in enumerate(group):
            if item[0] == v:
                if h >= 0:
                    self.hmap[h] = (k, i, xs)
                item[1][xs] += 1
                return
        c = [0, 0, 0]
        c[xs] = 1
        group.append([v, c])
        if h >= 0:
            self.hmap[h] = (k, len(group) - 1, xs)

    def add_set(self, other: "ChainSet"):
        """Merge another chain set (chain_set.cc:11-22)."""
        for group in other.chains:
            for v, c in group:
                self.add_counts(v, c)

    def remove(self, h):
        """Decrement the chain supported by hit h (chain_set.cc:125-136)."""
        p = self.hmap.pop(h, None)
        if p is None:
            return
        k, i, xs = p
        c = self.chains[k][i][1]
        c[xs] -= 1
        if c[xs] < 0:
            c[xs] = 0

    def get_chain(self, h):
        """Chain of hit h as a list; [] if none."""
        p = self.hmap.get(h)
        if p is None:
            return []
        return list(self.chains[p[0]][p[1]][0])

    def get(self, h):
        """(chain list, counts) of hit h."""
        p = self.hmap.get(h)
        if p is None:
            return [], [-1, -1, -1]
        item = self.chains[p[0]][p[1]]
        return list(item[0]), list(item[1])

    def get_splices(self):
        """Sorted unique splice positions over live chains (chain_set.cc:187-210)."""
        s = set()
        for group in self.chains:
            for v, c in group:
                if c[0] + c[1] + c[2] <= 0:
                    continue
                s.update(v)
        return sorted(s)

    def iter_chains(self):
        """All (chain, counts) pairs including zero-count ones
        (graph_builder::build_junctions iterates raw chains)."""
        for group in self.chains:
            for v, c in group:
                yield v, c

    def clear(self):
        self.pmap.clear()
        self.chains.clear()
        self.hmap.clear()


class PhaseSet:
    def __init__(self):
        self.pmap = {}    # tuple path -> count

    def add(self, v, c):
        if len(v) <= 0:
            return
        assert len(v) % 2 == 0
        v = tuple(v)
        self.pmap[v] = self.pmap.get(v, 0) + c

    def combine(self, other: "PhaseSet"):
        for v, c in other.pmap.items():
            self.pmap[v] = self.pmap.get(v, 0) + c

    def project_boundaries(self, smap, tmap):
        """Rewrite endpoints after boundary grouping (phase_set.cc:50-67)."""
        new = {}
        for v, c in self.pmap.items():
            v = list(v)
            if v[0] in smap:
                v[0] = smap[v[0]]
            if v[-1] in tmap:
                v[-1] = tmap[v[-1]]
            v = tuple(v)
            new[v] = new.get(v, 0) + c
        self.pmap = new

    def project_junctions(self, jm):
        """Rewrite junction coordinates (phase_set.cc:69-105)."""
        new = {}
        for v, c in self.pmap.items():
            vv = [v[0]]
            for k in range(len(v) // 2 - 1):
                p = (v[k * 2 + 1], v[k * 2 + 2])
                q = jm.get(p, p)
                vv.extend(q)
            vv.append(v[-1])
            if check_increasing(vv):
                t = tuple(vv)
                new[t] = new.get(t, 0) + c
        self.pmap = new
