"""Meta-level bundle: BundleBase + profile/config + bridging entry.

Re-implements meta/bundle.{h,cc}: ``bridge()`` builds the bundle's splice
graph, clusters unbridged pereads, runs the bridge solver against the
sample's insert-size window and applies the found chains; ``combine()``
merges another bundle's chain sets and coverage maps.
"""

from __future__ import annotations

from ..bridge.solver import BridgeSolver
from ..core.bundle import BundleBase
from ..core.graph import SpliceGraph
from ..core.graph_builder import GraphBuilder
from ..core.graph_cluster import build_pereads_clusters


class Bundle(BundleBase):
    def __init__(self, cfg, sp, base=None):
        super().__init__()
        self.cfg = cfg
        self.sp = sp
        self.gid = ""
        self.num_combined = 0
        if base is not None:
            # absorb the accumulated base (move semantics)
            self.tid = base.tid
            self.chrm = base.chrm
            self.lpos = base.lpos
            self.rpos = base.rpos
            self.strand = base.strand
            self.hits = base.hits
            self.frgs = base.frgs
            self.splices = base.splices
            self.hcst = base.hcst
            self.fcst = base.fcst
            self.mmap = base.mmap
            self.imap = base.imap
            self.frgs_ready = base.frgs_ready
            if getattr(base, "_light", False):
                self._light = True
            # native scanner arrays (cluster engine + native assembly core)
            for a in ("_scan_fixed", "_scan_coords", "_scan_mev",
                      "_scan_iev", "_scan_frgs", "_splices_arr",
                      "_scan_ptrs", "_scan_cnts", "_scan_rec"):
                v = getattr(base, a, None)
                if v is not None:
                    setattr(self, a, v)

    def set_gid(self, rid, g, instance, subindex):
        self.gid = "instance.%d.%d.%d.%d" % (rid, g, instance, subindex)

    def copy_meta_information(self, bb):
        self.chrm = bb.chrm
        self.strand = bb.strand
        self.tid = bb.tid
        self.lpos = bb.lpos
        self.rpos = bb.rpos

    def bridge(self):
        """meta/bundle.cc:55-88"""
        gr = SpliceGraph()
        GraphBuilder(self, self.cfg).build(gr)
        gr.build_vertex_index()
        vc = build_pereads_clusters(gr, self, self.cfg.max_reads_partition_gap)
        bs = BridgeSolver(gr, vc, self.cfg, self.sp.insertsize_low,
                          self.sp.insertsize_high)
        cnt = 0
        for k, pc in enumerate(vc):
            if bs.opt[k].type <= 0:
                continue
            cnt += self.update_bridges(pc.frlist, bs.opt[k].chain,
                                       bs.opt[k].strand)
        return cnt

    def combine(self, bb: "Bundle", combine_map=True):
        """meta/bundle.cc:90-107"""
        self.num_combined += bb.num_combined
        assert self.strand == bb.strand
        assert self.chrm == bb.chrm
        assert self.tid == bb.tid
        self.lpos = min(self.lpos, bb.lpos)
        self.rpos = max(self.rpos, bb.rpos)
        self.hcst.add_set(bb.hcst)
        self.fcst.add_set(bb.fcst)
        if combine_map:
            self.mmap.combine(bb.mmap)
            self.imap.combine(bb.imap)
