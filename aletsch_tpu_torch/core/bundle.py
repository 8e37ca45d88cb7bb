"""BundleBase: all hits of one gapless genomic window of one strand.

Re-implements rnacore/bundle_base.{h,cc}: hit accumulation with consecutive
duplicate collapsing and mate-extension of the right bound, fragment pairing
via qname-hash buckets, phase-path construction from bridged fragments, and
application of bridge chains back onto fragments and the coverage map.

frgs entries are [h1, h2, type] with type -1 unbridgeable / 0 to-bridge /
1 bridged-empty / 2 bridged-with-chain (bundle_base.h:38-47).
"""

from __future__ import annotations

from ..constants import UNSTRANDED
from ..utils.intervals import CoverageMap
from ..utils.seqs import check_increasing, merge_intron_chains
from .chain_set import ChainSet, PhaseSet

MATE_EXTEND_CAP = 500000   # bundle_base.cc:92


def materialize_bundle(sb, light=False):
    """BundleBase from a native ScanBundle (io/bam_native.py): the C++
    scanner already applied the add_hit dedup/extension rules, so hits are
    appended directly and the coverage maps build from the pre-concatenated
    interval arrays in bulk.

    light=True keeps only the scanner arrays plus the fields the grouping
    layer reads (bounds, strand, splices) — no Hit objects, no chain sets —
    for bundles that the native assembly core will consume whole."""
    from .hits import hit_from_row
    bb = BundleBase()
    bb.tid = sb.tid
    bb.lpos = sb.lpos
    bb.rpos = sb.rpos
    if light:
        import numpy as np
        sf = sb.fixed
        bb._light = True
        bb.strand = chr(int(sf[0, 22])) if sf.shape[0] else "."
        bb.frgs_ready = True
        xsp = getattr(sb, "xsp", None)
        if xsp is not None:
            bb._xs_pm = (xsp, sb.xsm)   # scanner-computed strand votes
        bb.mmap.add_pairs(sb.mev.reshape(-1, 2))
        bb.imap.add_pairs(sb.iev.reshape(-1, 2))
        spl = getattr(sb, "splices", None)
        if spl is not None:
            bb.splices = spl.tolist()      # sorted unique, from the scanner
            bb._splices_arr = spl          # int32 view for native grouping
        else:
            sc = sf[:, 19]
            rows_s = np.nonzero(sc)[0]
            if rows_s.size:
                offs = (sf[rows_s, 17] + 2 * sf[rows_s, 18]).tolist()
                lens = sc[rows_s].tolist()
                parts = [sb.coords[o:o + n] for o, n in zip(offs, lens)]
                bb.splices = np.unique(np.concatenate(parts)).tolist()
            else:
                bb.splices = []
        bb._scan_fixed = sb.fixed
        bb._scan_coords = sb.coords
        bb._scan_mev = sb.mev
        bb._scan_iev = sb.iev
        bb._scan_frgs = sb.frgs
        bb._scan_ptrs = getattr(sb, "ptrs", None)
        bb._scan_cnts = getattr(sb, "cnts", None)
        return bb
    rows = sb.fixed.tolist()
    qnames = sb.qnames
    hits = []
    for row in rows:
        ht = hit_from_row(row, qnames, row[24], qhash=row[23] & 0xFFFFFFFF)
        ht.strand = chr(row[22])
        hits.append(ht)
    bb.hits = hits
    if hits:
        bb.strand = hits[0].strand      # add_hit sets strand from hit 0
    bb.mmap.add_pairs(sb.mev.reshape(-1, 2))
    bb.imap.add_pairs(sb.iev.reshape(-1, 2))
    bb.frgs = [[int(a), int(b), 0] for a, b in sb.frgs.reshape(-1, 2)]
    bb.frgs_ready = True
    coords = sb.coords
    for j, row in enumerate(rows):
        sc = row[19]
        if sc:
            off = row[17] + 2 * row[18]
            bb.hcst.add(coords[off:off + sc].tolist(), j, hits[j].xs)
    # keep the scanner arrays: the native cluster engine derives its
    # hit-coordinate and chain exports from them zero-copy, and the native
    # assembly core (meta/native_core.py) consumes the full set
    bb._scan_fixed = sb.fixed
    bb._scan_coords = coords
    bb._scan_mev = sb.mev
    bb._scan_iev = sb.iev
    bb._scan_frgs = sb.frgs
    bb._scan_ptrs = getattr(sb, "ptrs", None)
    bb._scan_cnts = getattr(sb, "cnts", None)
    return bb


class BundleBase:
    def __init__(self):
        self.tid = -1
        self.chrm = ""
        self.lpos = 1 << 30
        self.rpos = 0
        self.strand = "."
        self.hits = []            # list[Hit]
        self.frgs = []            # list[[h1, h2, type]]
        self.frgs_ready = False   # True when the native scanner paired them
        self._frgs_mutated = False  # any frgs[k][2] write (native eligible())
        self.splices = []         # sorted unique splice positions
        self.hcst = ChainSet()    # per-hit intron chains
        self.fcst = ChainSet()    # per-fragment bridge chains
        self.mmap = CoverageMap() # match coverage
        self.imap = CoverageMap() # indel coverage

    # ------------------------------------------------------------- accretion
    def add_hit_intervals(self, ht, rec):
        """bundle_base.cc:33-47"""
        if self.add_hit(ht) != 0:
            return
        for s, p in rec.match_intervals():
            self.mmap.add(s, p, 1)
        for s, p in rec.indel_intervals():
            self.imap.add(s, p, 1)
        v = rec.extract_splices()
        if len(v) >= 1:
            self.hcst.add(v, len(self.hits) - 1, ht.xs)

    def add_hit_parsed(self, ht, coords, mcnt, scnt, icnt):
        """add_hit_intervals from a preparsed coordinate slice
        (columnar generator path): coords = [match pairs | splice coords |
        indel pairs]."""
        if self.add_hit(ht) != 0:
            return
        for i in range(mcnt):
            self.mmap.add(coords[2 * i], coords[2 * i + 1], 1)
        a = 2 * mcnt + scnt
        for i in range(icnt):
            self.imap.add(coords[a + 2 * i], coords[a + 2 * i + 1], 1)
        if scnt >= 1:
            self.hcst.add(coords[2 * mcnt:a], len(self.hits) - 1, ht.xs)

    def add_hit(self, ht):
        """bundle_base.cc:73-104; returns -1 on consecutive duplicate."""
        if self.hits:
            p = self.hits[-1]
            if p.pos == ht.pos and p.rpos == ht.rpos:
                return -1
        self.hits.append(ht)
        if ht.pos < self.lpos:
            self.lpos = ht.pos
        p = ht.rpos
        if ht.mpos > ht.rpos and ht.mpos <= ht.rpos + MATE_EXTEND_CAP:
            p = ht.mpos
        if p > self.rpos:
            self.rpos = p
        if self.tid == -1:
            self.tid = ht.tid
        if len(self.hits) <= 1:
            self.strand = ht.strand
        return 0

    def add_borrowed_path(self, p, w):
        """bundle_base.cc:49-71"""
        for k in range(len(p) // 2):
            p1, p2 = p[k * 2], p[k * 2 + 1]
            if p1 >= 0 and p2 >= 0:
                self.lpos = min(self.lpos, p1)
                self.rpos = max(self.rpos, p2)
                self.mmap.add(p1, p2, int(w))
            elif p1 < 0 and p2 < 0:
                self.hcst.add([-p1, -p2], -1, self.strand)

    def clear(self):
        self.tid = -1
        self.chrm = ""
        self.lpos = 1 << 30
        self.rpos = 0
        self.strand = "."
        self.hits = []
        self.frgs = []
        self.frgs_ready = False
        self._frgs_mutated = False
        self.splices = []
        self.hcst = ChainSet()
        self.fcst = ChainSet()
        self.mmap = CoverageMap()
        self.imap = CoverageMap()

    def compute_strand(self, libtype):
        """Vote bundle strand for unstranded libraries (bundle_base.cc:206-224)."""
        if libtype != UNSTRANDED:
            return
        pm = getattr(self, "_xs_pm", None)
        if pm is not None:
            np, nq = pm
        elif getattr(self, "_light", False):
            xs = self._scan_fixed[:, 12]
            np = int((xs == ord("+")).sum())
            nq = int((xs == ord("-")).sum())
        else:
            np = sum(1 for h in self.hits if h.xs == "+")
            nq = sum(1 for h in self.hits if h.xs == "-")
        if np > nq:
            self.strand = "+"
        elif np < nq:
            self.strand = "-"
        else:
            self.strand = "."

    # -------------------------------------------------------------- pairing
    def build_fragments(self):
        """Mate pairing by (qname-hash, pos, isize) buckets
        (bundle_base.cc:267-323).  The native scanner pre-pairs its bundles
        (pair_fragments in native/abam.cpp, bit-exact with this code)."""
        if self.frgs_ready:
            return
        self.frgs = []
        if not self.hits:
            return
        max_index = min(len(self.hits) + 1, 1000000)
        paired = [False] * len(self.hits)
        vv = [[] for _ in range(max_index)]
        for i, h in enumerate(self.hits):
            if h.hid < 0:
                continue
            k = (h.get_qhash() % max_index + h.pos % max_index
                 + (0 - h.isize) % max_index) % max_index
            vv[k].append(i)
        for i, h in enumerate(self.hits):
            if h.hid < 0 or paired[i]:
                continue
            k = (h.get_qhash() % max_index + h.mpos % max_index
                 + h.isize % max_index) % max_index
            x = -1
            for u in vv[k]:
                z = self.hits[u]
                if u == i or paired[u]:
                    continue
                if z.pos != h.mpos:
                    continue
                if z.isize + h.isize != 0:
                    continue
                if z.qname != h.qname:
                    continue
                x = u
                break
            if x == -1:
                continue
            self.frgs.append([i, x, 0])
            paired[i] = True
            paired[x] = True

    def count_unbridged(self):
        return sum(1 for f in self.frgs if f[2] == 0)

    # ------------------------------------------------------------- phase set
    def build_phase_set(self, ps: PhaseSet, gr):
        """bundle_base.cc:338-418"""
        fb = [-1] * len(self.hits)
        for i, f in enumerate(self.frgs):
            if f[2] <= -1:
                continue
            h1, h2 = f[0], f[1]
            if f[2] == 0:
                fb[h1] = 0
                fb[h2] = 0
                continue
            u1 = gr.locate_vertex(self.hits[h1].pos)
            u2 = gr.locate_vertex(self.hits[h2].rpos - 1)
            if u1 < 0 or u2 < 0:
                continue
            p1 = gr.get_vertex_info(u1).lpos
            p2 = gr.get_vertex_info(u2).rpos
            v1 = self.hcst.get_chain(h1)
            v2 = self.hcst.get_chain(h2)
            xy = []
            if f[2] == 1:
                ok, xy = merge_intron_chains(v1, v2)
                if not ok:
                    continue
            if f[2] >= 2:
                vv = self.fcst.get_chain(i)
                xy = list(v1) + list(vv) + list(v2)
            xy = [p1] + xy + [p2]
            if not check_increasing(xy):
                continue
            fb[h1] = 1
            fb[h2] = 1
            ps.add(xy, 1)
        for i, h in enumerate(self.hits):
            if fb[i] >= 0 or h.hid < 0:
                continue
            u1 = gr.locate_vertex(h.pos)
            u2 = gr.locate_vertex(h.rpos - 1)
            if u1 < 0 or u2 < 0:
                continue
            p1 = gr.get_vertex_info(u1).lpos
            p2 = gr.get_vertex_info(u2).rpos
            xy = [p1] + self.hcst.get_chain(i) + [p2]
            if not check_increasing(xy):
                continue
            ps.add(xy, 1)

    # --------------------------------------------------------------- bridges
    def update_bridges(self, frlist, chain, strand):
        """Apply one bridge chain to a list of fragments
        (bundle_base.cc:420-507).  strand is 0/1/2."""
        self._frgs_mutated = True
        cnt = 0
        for k in frlist:
            assert self.frgs[k][2] == 0
            h1 = self.hits[self.frgs[k][0]]
            h2 = self.hits[self.frgs[k][1]]
            v1 = [h1.rpos] + list(chain) + [h2.pos]
            if h1.rpos < h2.pos and not check_increasing(v1):
                continue
            cnt += 1
            if len(chain) <= 0:
                self.frgs[k][2] = 1
            else:
                s = "."
                if h1.xs != ".":
                    s = h1.xs
                if h2.xs != ".":
                    s = h2.xs
                if h1.xs != "." and h2.xs != "." and h1.xs != h2.xs:
                    s = "."
                ss = "."
                if strand == 1:
                    ss = "+"
                if strand == 2:
                    ss = "-"
                self.frgs[k][2] = 2
                if s == ss:
                    self.fcst.add(chain, k, ss)
                elif s != "." and ss == ".":
                    self.fcst.add(chain, k, s)
                elif ss != "." and s == ".":
                    self.fcst.add(chain, k, ss)
                else:
                    self.fcst.add(chain, k, ".")
            for j in range(len(v1) // 2):
                p1, p2 = v1[j * 2], v1[j * 2 + 1]
                if p1 >= p2:
                    continue
                self.mmap.add(p1, p2, 1)
        return cnt

    def eliminate_bridge(self, k):
        """bundle_base.cc:509-538"""
        self._frgs_mutated = True
        assert self.frgs[k][2] >= 1
        h1 = self.hits[self.frgs[k][0]]
        h2 = self.hits[self.frgs[k][1]]
        chain = self.fcst.get_chain(k)
        v1 = [h1.rpos] + chain + [h2.pos]
        for i in range(len(v1) // 2):
            p1, p2 = v1[i * 2], v1[i * 2 + 1]
            if p1 >= p2:
                continue
            self.mmap.add(p1, p2, -1)
        self.frgs[k][2] = -1
        self.fcst.remove(k)

    def eliminate_hit(self, k):
        """bundle_base.cc:540-566"""
        h1 = self.hits[k]
        assert h1.hid >= 0
        chain = self.hcst.get_chain(k)
        v1 = [h1.pos] + chain + [h1.rpos]
        for i in range(len(v1) // 2):
            p1, p2 = v1[i * 2], v1[i * 2 + 1]
            if p1 >= p2:
                continue
            self.mmap.add(p1, p2, -1)
        h1.hid = -1
        self.hcst.remove(k)

    def filter_multialigned_hits(self):
        """bundle_base.cc:613-679"""
        self._frgs_mutated = True
        bridged = set()
        primary = set()
        for f in self.frgs:
            if f[2] <= 0:
                continue
            h1, h2 = self.hits[f[0]], self.hits[f[1]]
            bridged.add(h1.qname)
            if (h1.flag & 0x100) <= 0 and (h2.flag & 0x100) <= 0:
                primary.add(h1.qname)
        for f in self.frgs:
            if f[2] >= 1:
                continue
            h1, h2 = f[0], f[1]
            if self.hits[h1].qname not in primary:
                continue
            self.eliminate_hit(h1)
            self.eliminate_hit(h2)
            f[2] = -1
        for i, f in enumerate(self.frgs):
            if f[2] <= 0:
                continue
            h1, h2 = f[0], f[1]
            if (self.hits[h1].flag & 0x100) <= 0:
                continue
            if (self.hits[h2].flag & 0x100) <= 0:
                continue
            if self.hits[h1].qname not in primary:
                continue
            self.eliminate_bridge(i)
            self.eliminate_hit(h1)
            self.eliminate_hit(h2)
        paired = [False] * len(self.hits)
        for f in self.frgs:
            paired[f[0]] = True
            paired[f[1]] = True
        for i, h in enumerate(self.hits):
            if paired[i]:
                continue
            if h.qname not in bridged:
                continue
            if h.hid < 0:
                continue
            self.eliminate_hit(i)
