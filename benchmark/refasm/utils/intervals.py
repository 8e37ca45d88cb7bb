"""Coverage maps as coordinate-compressed difference arrays.

The reference leans on boost::icl interval maps for read coverage
(rnacore/interval_map.{h,cc}).  A TPU-native design wants flat
arrays instead of balanced trees: we record (pos, +w)/(pos, -w) events and
lazily compress them into sorted breakpoints + per-segment values.  This
reproduces split_interval_map semantics exactly:

* every inserted endpoint is a segment border (split maps never re-join),
* segments whose accumulated value is 0 are absent from the map,
* boundary queries [x, y) return the *fully contained* present segments,
  matching locate_boundary_iterators (interval_map.cc:70-87).

All segment queries are O(log n) + O(segments) on numpy arrays, and the
finalized arrays are directly consumable by batched JAX kernels.
"""

from __future__ import annotations

import numpy as np
from bisect import bisect_left, bisect_right

# shared zero-length arrays: CoverageMap construction is per-bundle hot
# (never mutated in place -- _build/clear only REASSIGN _bps/_vals)
_EMPTY_I64 = np.empty(0, dtype=np.int64)


class CoverageMap:
    """Integer-weighted coverage map over int32 genomic coordinates."""

    __slots__ = ("_events", "_chunks", "_bps", "_vals", "_dirty", "_segs",
                 "_seg_ls")

    def __init__(self):
        self._events = []          # list of (pos, delta)
        self._chunks = []          # bulk unit-weight interval arrays (N, 2)
        self._bps = _EMPTY_I64    # breakpoints, len = S+1
        self._vals = _EMPTY_I64   # per-segment value, len = S
        self._dirty = False
        self._segs = None          # cached (l, r, v) of present segments
        self._seg_ls = None        # cached list forms of (l, r) for bisect

    def add(self, l: int, r: int, w: int = 1):
        """mmap += ([l, r), w); negative w subtracts."""
        if l >= r or w == 0:
            return
        self._events.append((l, w))
        self._events.append((r, -w))
        self._dirty = True
        self._segs = None
        self._seg_ls = None

    def add_many(self, ls, rs, ws=None):
        if ws is None:
            ws = np.ones(len(ls), dtype=np.int64)
        for l, r, w in zip(ls, rs, ws):
            self.add(int(l), int(r), int(w))

    def add_pairs(self, arr):
        """Bulk add of unit-weight [l, r) intervals from an (N, 2) array
        (native scanner output); degenerate rows (l >= r) are ignored like
        add().  Filtering/conversion is deferred to _build so maps that are
        never queried (light bundles) cost nothing here."""
        if len(arr) == 0:
            return
        self._chunks.append(arr)
        self._dirty = True
        self._segs = None
        self._seg_ls = None

    def clear(self):
        self._events.clear()
        self._chunks = []
        self._bps = _EMPTY_I64
        self._vals = _EMPTY_I64
        self._dirty = False
        self._segs = None
        self._seg_ls = None

    def combine(self, other: "CoverageMap"):
        """mmap += other (bundle::combine, meta/bundle.cc:102-103)."""
        self._events.extend(other._events)
        self._chunks.extend(other._chunks)
        self._dirty = True
        self._segs = None
        self._seg_ls = None

    # ------------------------------------------------------------------ build
    def _build(self):
        if not self._dirty:
            return
        self._dirty = False
        if not self._events and not self._chunks:
            self._bps = np.empty(0, dtype=np.int64)
            self._vals = np.empty(0, dtype=np.int64)
            return
        parts_p = []
        parts_d = []
        if self._events:
            ev = np.asarray(self._events, dtype=np.int64)
            parts_p.append(ev[:, 0])
            parts_d.append(ev[:, 1])
        for ch in self._chunks:
            ch = np.asarray(ch, dtype=np.int64).reshape(-1, 2)
            ch = ch[ch[:, 0] < ch[:, 1]]          # drop degenerate rows
            if ch.size == 0:
                continue
            parts_p.append(ch.reshape(-1))
            d = np.empty(ch.shape[0] * 2, dtype=np.int64)
            d[0::2] = 1
            d[1::2] = -1
            parts_d.append(d)
        if not parts_p:
            self._bps = np.empty(0, dtype=np.int64)
            self._vals = np.empty(0, dtype=np.int64)
            return
        pos = np.concatenate(parts_p)
        dlt = np.concatenate(parts_d)
        order = np.argsort(pos, kind="stable")
        pos = pos[order]
        dlt = dlt[order]
        # aggregate deltas at identical breakpoints
        bps, idx = np.unique(pos, return_index=True)
        agg = np.add.reduceat(dlt, idx)
        vals = np.cumsum(agg)[:-1]          # value of segment [bps[i], bps[i+1])
        self._bps = bps
        self._vals = vals

    @property
    def segments(self):
        """(l, r, v) arrays of *present* (nonzero) segments (cached)."""
        if self._segs is not None and not self._dirty:
            return self._segs
        self._build()
        if self._bps.size == 0:
            z = _EMPTY_I64
            self._segs = (z, z, z)
        else:
            l = self._bps[:-1]
            r = self._bps[1:]
            m = self._vals != 0
            self._segs = (l[m], r[m], self._vals[m])
        return self._segs

    def __bool__(self):
        l, _, _ = self.segments
        return l.size > 0

    # ---------------------------------------------------------------- queries
    def find_value(self, p: int) -> int:
        """Value covering position p; 0 if absent (compute_overlap)."""
        self._build()
        if self._bps.size == 0:
            return 0
        i = int(np.searchsorted(self._bps, p, side="right")) - 1
        if i < 0 or i >= self._vals.size:
            return 0
        return int(self._vals[i])

    def contains(self, p: int) -> bool:
        return self.find_value(p) != 0

    def contained(self, x: int, y: int):
        """Present segments fully inside [x, y] (locate_boundary_iterators)."""
        l, r, v = self.segments
        if l.size == 0:
            z = _EMPTY_I64
            return z, z, z
        # scalar searchsorted on numpy arrays costs ~microseconds; bisect on
        # cached lists is ~10x cheaper and exact (integer keys)
        ll, rl = self._seg_lists()
        a = bisect_left(ll, x)
        b = bisect_right(rl, y)
        if a >= b:
            z = _EMPTY_I64
            return z, z, z
        return l[a:b], r[a:b], v[a:b]

    def _seg_lists(self):
        if self._seg_ls is None:
            l, r, _ = self.segments
            self._seg_ls = (l.tolist(), r.tolist())
        return self._seg_ls

    def evaluate_rectangle(self, ll: int, rr: int):
        """(ave, dev, max) of coverage over [ll, rr) (interval_map.cc:166-195).

        Gaps inside [ll, rr) count as zero toward the average but contribute
        no variance term, matching the reference exactly.  Accumulations are
        sequential left-to-right doubles (NOT numpy pairwise summation) so a
        native port can reproduce them bit-exactly.
        """
        l, r, v = self.contained(ll, rr)
        if l.size == 0:
            return 0.0, 1.0, 0.0
        ll_l = l.tolist()
        rl = r.tolist()
        vl = v.tolist()
        mx = float(vl[0])
        s = 0.0
        for i in range(len(vl)):
            w = float(vl[i])
            if w > mx:
                mx = w
            s += (rl[i] - ll_l[i]) * w
        ave = s / (rr - ll)
        var = 0.0
        for i in range(len(vl)):
            d = float(vl[i]) - ave
            var += (rl[i] - ll_l[i]) * (d * d)
        dev = float(np.sqrt(var / (rr - ll)))
        return ave, dev, mx

    def sum_overlap(self, ll: int, rr: int) -> float:
        """Integer area of contained segments (exact in any order)."""
        l, r, v = self.contained(ll, rr)
        if l.size == 0:
            return 0.0
        return float(((r - l) * v).sum())

    def covered_runs(self, ll: int, rr: int):
        """Maximal runs of contained covered segments as [(p1, p2), ...].

        Equivalent to region::build_join_interval_map (region.cc:34-58):
        contained mmap segments poured into a join map coalesce when touching.
        """
        l, r, _ = self.contained(ll, rr)
        n = l.size
        if n == 0:
            return []
        br = np.nonzero(l[1:] != r[:-1])[0]
        starts = np.concatenate(([0], br + 1))
        ends = np.concatenate((br, [n - 1]))
        ls = l[starts].tolist()
        rs = r[ends].tolist()
        return list(zip(ls, rs))

    def total_covered_length(self) -> int:
        l, r, _ = self.segments
        return int((r - l).sum())
