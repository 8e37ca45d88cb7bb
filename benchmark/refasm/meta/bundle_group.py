"""Cross-sample clustering of bundles for one (chrm, strand, region).

Re-implements meta/bundle_group.{h,cc}: duplicate suppression against the
previous region's overflow, a splice-position -> bundle index, two rounds of
pairwise splice-set similarity (|intersection| / min(|A|, |B|)) at
max_grouping_similarity then min_grouping_similarity, requiring >= 1 shared
splice, skipping junction-heavy bundles, with greedy best-first union into a
size-capped disjoint set.

The pairwise set intersections are the O(n^2) hot spot at scale; the batched
TPU path (ops/similarity.py) computes the same counts as a binary matmul over
a per-region splice incidence matrix.
"""

from __future__ import annotations

from ..ops.similarity import pairwise_splice_similarity
from .transcript_store import new_transcript_set


class DisjointSet:
    """rnacore/disjoint_set.{h,cc}: union-find + explicit root sizes."""

    def __init__(self, n):
        self.parent = list(range(n))
        self.size = [1] * n
        self.rank = [0] * n

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def link(self, x, y):
        x, y = self.find(x), self.find(y)
        if x == y:
            return x
        if self.rank[x] < self.rank[y]:
            x, y = y, x
        self.parent[y] = x
        if self.rank[x] == self.rank[y]:
            self.rank[x] += 1
        return x

    def get_size(self, x):
        return self.size[self.find(x)]

    def set_size(self, x, s):
        self.size[self.find(x)] = s


class BundleGroup:
    def __init__(self, chrm, strand, rid, cfg, sidx):
        self.chrm = chrm
        self.strand = strand
        self.rid = rid
        self.cfg = cfg
        self.sidx = sidx          # chrm -> [(sid, tid)]
        self.gset = []            # bundles from all samples
        self.gvv = []             # resulting groups (bundle indices)
        self.tmerge = new_transcript_set(chrm, rid, cfg)
        self.num_assembled = 0
        self.grouped = []

    def _use_device_similarity(self):
        """Route the clustering rounds through the device similarity forms
        (ops/similarity.py) instead of the native intersections.  Default
        "auto" asks the measured policy about this stage's own fit
        (meta/device_wave.py auto_device_ok over ops/crossover.py: engage
        iff a + b*n < c*n with a/b/c measured for the sparse form against
        the native clustering, at this region's n bundles) AND requires at
        least device_min_cluster bundles (48: below it the product runs in
        numpy anyway)."""
        import os
        mode = getattr(self.cfg, "device_similarity", "auto")
        if os.environ.get("ALETSCH_DEVICE") == "0" or mode == "off":
            return False
        if mode == "on":
            return True
        if len(self.gset) < getattr(self.cfg, "device_min_cluster", 48):
            return False
        from .device_wave import auto_device_ok
        return auto_device_ok(self.cfg, len(self.gset), stage="similarity")

    def resolve(self):
        """bundle_group.cc:26-56; the clustering rounds run natively
        (core_cluster_groups) when the library is available — same splice
        index, similarity thresholds, greedy capped union, group order —
        or through the batched device similarity (byte-identical,
        fuzz-pinned) when _use_device_similarity says the MXU wins."""
        self.remove_duplicates()
        if not self._use_device_similarity():
            from .native_core import cluster_groups_native
            gids = cluster_groups_native(self.gset, self.cfg)
            if gids is not None:
                if len(gids) < 256:
                    # numpy per-call overhead loses on small regions
                    # (core/graph_cluster.py vectorization lesson)
                    self.gvv = []
                    for i, g in enumerate(gids.tolist()):
                        if g == len(self.gvv):
                            self.gvv.append([i])
                        else:
                            self.gvv[g].append(i)
                    return
                # ids are assigned in first-encounter order, so a stable
                # argsort groups them with members in index order —
                # identical lists to the per-bundle append loop
                import numpy as np
                g = np.asarray(gids)
                order = np.argsort(g, kind="stable").tolist()
                counts = np.bincount(g).tolist()
                gvv = []
                pos = 0
                for c in counts:
                    gvv.append(order[pos:pos + c])
                    pos += c
                self.gvv = gvv
                return
        sindex = self._build_splice_index()
        ds = DisjointSet(len(self.gset))
        self.grouped = [False] * len(self.gset)
        for _, s in sorted(sindex.items()):
            if len(s) <= 1:
                continue
            self._process_subset(s, ds, self.cfg.max_grouping_similarity)
        for _, s in sorted(sindex.items()):
            if len(s) <= 1:
                continue
            self._process_subset(s, ds, self.cfg.min_grouping_similarity)
        self._build_groups(ds)

    def remove_duplicates(self):
        """Drop bundles wholly inside the previous region's overflow
        (bundle_group.cc:58-91)."""
        if self.rid <= 0:
            return
        if self.chrm not in self.sidx:
            return
        mv = dict(self.sidx[self.chrm])
        for bd in self.gset:
            sid = bd.sp.sample_id
            tid = mv.get(sid)
            if tid is None:
                continue
            if self.strand == "+":
                end = bd.sp.end1[tid][self.rid - 1]
            elif self.strand == "-":
                end = bd.sp.end2[tid][self.rid - 1]
            else:
                continue
            if bd.rpos > end:
                continue
            bd.clear()
            bd.splices = []

    def _build_splice_index(self):
        """bundle_group.cc:150-172"""
        sindex = {}
        for k, bd in enumerate(self.gset):
            for p in bd.splices:
                sindex.setdefault(p, set()).add(k)
        return sindex

    def _process_subset(self, s, ds, min_similarity):
        """bundle_group.cc:123-133"""
        ss = []
        for z in sorted(s):
            if self.grouped[z]:
                continue
            if ds.get_size(z) >= self.cfg.max_group_size:
                self.grouped[z] = True
                continue
            ss.append(z)
        vpid = self._build_splice_similarity(ss, ds, min_similarity)
        self._augment(vpid, ds)

    def _build_splice_similarity(self, ss, ds, min_similarity):
        """Pairwise similarity over candidate bundles
        (bundle_group.cc:190-231); delegates counting to the batched kernel
        for large subsets."""
        cfg = self.cfg
        cand = [i for i in ss
                if len(self.gset[i].splices) / 2.0 <= cfg.max_num_junctions_to_combine]
        vpid = []
        pairs = pairwise_splice_similarity(
            [self.gset[i].splices for i in cand], min_similarity)
        for xi, xj, c, r in pairs:
            i, j = cand[xi], cand[xj]
            if ds.find(i) == ds.find(j):
                continue
            vpid.append(((i, j), r))
        vpid.sort(key=lambda x: -x[1])
        return vpid

    def _augment(self, vpid, ds):
        """Greedy best-first union with size cap (bundle_group.cc:296-318)."""
        for (x, y), _ in vpid:
            px = ds.find(x)
            py = ds.find(y)
            if px == py:
                continue
            sx = ds.get_size(px)
            sy = ds.get_size(py)
            if sx >= self.cfg.max_group_size or sy >= self.cfg.max_group_size:
                continue
            q = ds.link(px, py)
            ds.set_size(q, sx + sy)

    def _build_groups(self, ds):
        """bundle_group.cc:320-342"""
        mm = {}
        self.gvv = []
        for i in range(len(self.gset)):
            p = ds.find(i)
            if p not in mm:
                mm[p] = len(self.gvv)
                self.gvv.append([i])
            else:
                self.gvv[mm[p]].append(i)

    def clear(self):
        self.gvv = []
        self.grouped = []
        self.num_assembled = 0
