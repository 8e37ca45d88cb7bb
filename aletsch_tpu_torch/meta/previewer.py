"""Sample previewing: library-type and insert-size inference.

Re-implements meta/previewer.{h,cc}: sample up to max_preview_reads, compare
XS tags against flag-predicted orientation of spliced reads (>= 0.8 agreement
-> FR_FIRST/FR_SECOND else UNSTRANDED, previewer.cc:29-149); assemble preview
bundles, merge mate intron chains, and histogram fragment inner distances to
set insertsize low (0.5%ile) / high (99%ile) / median / mean / std
(previewer.cc:151-305).
"""

from __future__ import annotations

import math

from ..constants import FR_FIRST, FR_SECOND, UNSTRANDED
from ..core.bundle import BundleBase
from ..core.graph import SpliceGraph
from ..core.graph_builder import GraphBuilder
from ..core.graph_cluster import build_pereads_clusters
from ..core.hits import Hit, hit_from_row, strand_from_flag
from ..core.essential import get_total_length_of_introns
from ..io.bam import FSECONDARY, FUNMAP
from ..io.bam_native import open_bam
from ..utils.seqs import merge_intron_chains


class Previewer:
    def __init__(self, cfg, sp):
        self.cfg = cfg
        self.sp = sp

    def infer_library_type(self):
        """previewer.cc:29-148

        With the native batch decoder the scan is vectorized: per-record
        filters, splice detection and the flag-predicted orientation are
        computed on flat arrays; Python touches nothing per record."""
        with open_bam(self.sp.align_file) as r:
            if hasattr(r, "read_batch_arrays"):
                return self._infer_library_type_batched(r)
            return self._infer_library_type_slow(r)

    def _infer_library_type_batched(self, r):
        import numpy as np
        cfg = self.cfg
        sp = self.sp
        total = spliced = num_xs = 0
        n1 = n2 = 0            # len(spn1), len(spn2)
        first = second = 0
        cap = cfg.max_preview_spliced_reads
        while True:
            if total >= cfg.max_preview_reads:
                break
            if n1 >= cap and n2 >= cap:
                break
            b = r.read_batch_arrays()
            if b is None:
                break
            f = b.fixed
            flag = f[:, 4]
            keep = ((flag & 0x4) == 0) & ((flag & 0x100) == 0) & \
                (f[:, 8] <= cfg.max_num_cigar) & (f[:, 8] >= 1) & \
                (f[:, 3] >= cfg.min_mapping_quality)
            # honor the total cap within the batch
            kept = np.nonzero(keep)[0]
            room = cfg.max_preview_reads - total
            if kept.size > room:
                kept = kept[:room]
            total += kept.size
            sp_mask = f[kept, 16] > 0
            spl = kept[sp_mask]
            spliced += spl.size
            xs = f[spl, 12]
            has_xs = xs != ord(".")
            num_xs += int(has_xs.sum())
            sel = spl[has_xs]
            if sel.size == 0:
                continue
            fl = f[sel, 4]
            paired = (fl & 0x1) >= 1
            rev = (fl & 0x10) >= 1
            mrev = (fl & 0x20) >= 1
            r1 = (fl & 0x40) >= 1
            r2 = (fl & 0x80) >= 1
            pred = np.full(sel.size, ord("."), dtype=np.int32)
            pred = np.where(paired & ~rev & mrev & r1 & ~r2, ord("-"), pred)
            pred = np.where(paired & rev & ~mrev & ~r1 & r2, ord("-"), pred)
            pred = np.where(paired & rev & ~mrev & r1 & ~r2, ord("+"), pred)
            pred = np.where(paired & ~rev & mrev & ~r1 & r2, ord("+"), pred)
            pred = np.where(~paired, np.where(rev, ord("+"), ord("-")), pred)
            tag = f[sel, 12]
            plus = pred == ord("+")
            minus = pred == ord("-")
            agree = pred == tag
            # apply per-strand caps (order within batch preserved)
            ci = np.cumsum(plus)
            cj = np.cumsum(minus)
            take_p = plus & (n1 + ci <= cap)
            take_m = minus & (n2 + cj <= cap)
            n1 += int(take_p.sum())
            n2 += int(take_m.sum())
            first += int((take_p & agree).sum() + (take_m & agree).sum())
            second += int((take_p & ~agree).sum() + (take_m & ~agree).sum())
        self._finish_library_type(total, spliced, num_xs, n1, n2,
                                  first, second)

    def _finish_library_type(self, total, spliced, num_xs, n1, n2,
                             first, second):
        cfg = self.cfg
        sp = self.sp
        spn = (n1 + n2) // 2
        sp.num_xs = num_xs
        sp.spn = spn
        s1 = UNSTRANDED
        if spn >= cfg.min_preview_spliced_reads and \
                first > cfg.preview_infer_ratio * 2.0 * spn:
            s1 = FR_FIRST
        if spn >= cfg.min_preview_spliced_reads and \
                second > cfg.preview_infer_ratio * 2.0 * spn:
            s1 = FR_SECOND
        sp.library_type = s1
        sp.bam_with_xs = 1 if spliced > 0 and \
            num_xs / spliced > cfg.preview_infer_ratio else 0

    def _infer_library_type_slow(self, r):
        cfg = self.cfg
        sp = self.sp
        total = spliced = num_xs = 0
        spn1 = []
        spn2 = []
        if True:
            while True:
                if total >= cfg.max_preview_reads:
                    break
                if (len(spn1) >= cfg.max_preview_spliced_reads and
                        len(spn2) >= cfg.max_preview_spliced_reads):
                    break
                rec = r.read_rec()
                if rec is None:
                    break
                if rec.flag & FUNMAP or rec.flag & FSECONDARY:
                    continue
                if rec.n_cigar > cfg.max_num_cigar or rec.n_cigar < 1:
                    continue
                if rec.mapq < cfg.min_mapping_quality:
                    continue
                total += 1
                spos = rec.extract_splices()
                if len(spos) <= 0:
                    continue
                spliced += 1
                if rec.xs == ".":
                    continue
                num_xs += 1
                if rec.xs == "+" and len(spn1) >= cfg.max_preview_spliced_reads:
                    continue
                if rec.xs == "-" and len(spn2) >= cfg.max_preview_spliced_reads:
                    continue
                f = rec.flag
                xs = "."
                paired = (f & 0x1) >= 1
                rev = (f & 0x10) >= 1
                mrev = (f & 0x20) >= 1
                r1 = (f & 0x40) >= 1
                r2 = (f & 0x80) >= 1
                if paired and not rev and mrev and r1 and not r2:
                    xs = "-"
                if paired and rev and not mrev and not r1 and r2:
                    xs = "-"
                if paired and rev and not mrev and r1 and not r2:
                    xs = "+"
                if paired and not rev and mrev and not r1 and r2:
                    xs = "+"
                if not paired:
                    xs = "+" if rev else "-"
                if xs == "+":
                    spn1.append(1 if xs == rec.xs else 2)
                if xs == "-":
                    spn2.append(1 if xs == rec.xs else 2)
        spn = (len(spn1) + len(spn2)) // 2
        first = sum(1 for v in spn1 if v == 1) + sum(1 for v in spn2 if v == 1)
        second = sum(1 for v in spn1 if v == 2) + sum(1 for v in spn2 if v == 2)
        sp.num_xs = num_xs
        sp.spn = spn
        s1 = UNSTRANDED
        if spn >= cfg.min_preview_spliced_reads and first > cfg.preview_infer_ratio * 2.0 * spn:
            s1 = FR_FIRST
        if spn >= cfg.min_preview_spliced_reads and second > cfg.preview_infer_ratio * 2.0 * spn:
            s1 = FR_SECOND
        sp.library_type = s1
        sp.bam_with_xs = 1 if spliced > 0 and num_xs / spliced > cfg.preview_infer_ratio else 0

    def infer_insertsize(self, capture_regions=False):
        """previewer.cc:151-249

        capture_regions: also build the sample's region grid on this same
        decode pass (native boundary tracker) so the later
        set_batch_boundaries sweep is skipped — one full-file decode
        instead of two.  Only on the native pooled path and never in
        ALETSCH_REF_QUIRKS mode (the quirks region tables need their own
        reference-exact pass)."""
        import os as _os

        from .native_core import (collect_insertsizes_chunked,
                                  preview_chunks_available)
        with open_bam(self.sp.align_file) as r:
            if (hasattr(r, "scan_preview_pools")
                    and preview_chunks_available()):
                sink = None
                if capture_regions and hasattr(r, "_fill_boundaries") \
                        and _os.environ.get("ALETSCH_REF_QUIRKS") != "1" \
                        and getattr(r._lib, "abam_scan_enable_boundaries",
                                    None) is not None:
                    self.sp._init_tables(r.header)
                    sink = (self.sp.region_partition_length, self.sp)
                m = collect_insertsizes_chunked(r, self.cfg,
                                                self.sp.library_type,
                                                boundary_sink=sink)
                if sink is not None:
                    self.sp._preview_regions = (self.cfg.min_bundle_gap,
                                                self.cfg.max_read_span)
            elif hasattr(r, "scan_preview"):
                m = self._collect_insertsizes_scan(r)
            elif hasattr(r, "read_batch_arrays"):
                m = self._collect_insertsizes_batched(r)
            else:
                m = self._collect_insertsizes_slow(r)
        self._finish_insertsize(m)

    def _collect_insertsizes_scan(self, r):
        """Native-scanner variant: bundle splitting runs in C++; Python only
        runs _process per flushed bundle.  The max_preview_reads cap stops
        after the last bundle flushed by the capping record (epoch ties)."""
        from ..core.bundle import materialize_bundle
        from ..io.bam_native import scan_params
        cfg = self.cfg
        m = {}
        cnt = 0
        capped_epoch = None
        pr = scan_params(cfg, self.sp.library_type)
        from .native_core import native_core_available, preview_bundle_native
        gen = r.scan_preview(pr, need_qnames=not native_core_available())
        for chunk in gen:
            for sb in chunk:
                if capped_epoch is not None and sb.epoch != capped_epoch:
                    gen.close()
                    return m
                nh = sb.fixed.shape[0]
                if (cfg.min_num_hits_in_bundle <= nh <= 20000
                        and sb.tid >= 0):
                    ds = preview_bundle_native(sb, cfg)
                else:
                    ds = [] if sb.tid >= 0 else None
                if ds is None:
                    cnt += self._process(materialize_bundle(sb), m)
                else:
                    for d in ds:
                        m[d] = m.get(d, 0) + 1
                    cnt += len(ds)
                if capped_epoch is None and cnt >= cfg.max_preview_reads:
                    capped_epoch = sb.epoch
        return m

    def _collect_insertsizes_batched(self, r):
        """Columnar variant of the insert-size scan: per-record filters on
        flat arrays, Hit assembly only for surviving records."""
        import numpy as np
        cfg = self.cfg
        sp = self.sp
        lt = sp.library_type
        unstranded = lt == UNSTRANDED
        m = {}
        cnt = 0
        hid = 0
        bb1 = BundleBase()
        bb1.strand = "+"
        bb2 = BundleBase()
        bb2.strand = "-"
        stop = False
        while not stop:
            b = r.read_batch_arrays()
            if b is None:
                break
            f = b.fixed
            flag = f[:, 4]
            keep = ((flag & 0x4) == 0) & ((flag & 0x100) == 0) & \
                (f[:, 8] <= cfg.max_num_cigar) & (f[:, 8] >= 1) & \
                (f[:, 3] >= cfg.min_mapping_quality)
            idx = np.nonzero(keep)[0]
            if idx.size == 0:
                continue
            rows = f[idx].tolist()
            for row in rows:
                rtid, rpos = row[0], row[1]
                rhid = hid
                hid += 1
                if rtid != bb1.tid or rpos > bb1.rpos + cfg.min_bundle_gap:
                    cnt += self._process(bb1, m)
                    bb1 = BundleBase()
                    bb1.strand = "+"
                if rtid != bb2.tid or rpos > bb2.rpos + cfg.min_bundle_gap:
                    cnt += self._process(bb2, m)
                    bb2 = BundleBase()
                    bb2.strand = "-"
                if cnt >= cfg.max_preview_reads:
                    stop = True
                    break
                if cfg.uniquely_mapped_only and row[14] != 1:
                    continue
                xs = chr(row[12])
                strand = strand_from_flag(row[4], lt)
                if not unstranded:
                    if strand == "+" and xs == "-":
                        continue
                    if strand == "-" and xs == "+":
                        continue
                    if strand == "." and xs != ".":
                        strand = xs
                coff = row[17]
                cend = coff + 2 * row[18] + row[19] + 2 * row[20]
                coords = b.coords[coff:cend].tolist()
                mcnt, scnt, icnt = row[18], row[19], row[20]
                ht = hit_from_row(row, b.qnames, rhid)
                ht.strand = strand
                if not unstranded:
                    if strand == "+":
                        bb1.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                    if strand == "-":
                        bb2.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                else:
                    if xs == "+":
                        bb1.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                    elif xs == "-":
                        bb2.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                    else:
                        bb1.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                        bb2.add_hit_parsed(ht.clone(), coords, mcnt,
                                           scnt, icnt)
        return m

    def _finish_insertsize(self, m):
        cfg = self.cfg
        sp = self.sp
        total = sum(m.values())
        sp.insert_total = total
        if total < cfg.min_preview_spliced_reads:
            return
        n = 0
        sx2 = 0.0
        ave = 0.0
        sp.insertsize_low = -1
        sp.insertsize_high = -1
        sp.insertsize_median = -1
        for d, c in sorted(m.items()):
            n += c
            if n >= 0.5 * total and sp.insertsize_median < 0:
                sp.insertsize_median = d
            ave += c * d
            sx2 += c * d * d
            if sp.insertsize_low == -1 and n >= 0.005 * total:
                sp.insertsize_low = d
            if sp.insertsize_high == -1 and n >= 0.990 * total:
                sp.insertsize_high = d
            if n >= 0.998 * total:
                break
        sp.insertsize_ave = ave / n
        var = (sx2 - n * sp.insertsize_ave * sp.insertsize_ave) / n
        sp.insertsize_std = math.sqrt(max(var, 0.0))

    def _collect_insertsizes_slow(self, r):
        cfg = self.cfg
        sp = self.sp
        m = {}
        cnt = 0
        hid = 0
        bb1 = BundleBase()
        bb1.strand = "+"
        bb2 = BundleBase()
        bb2.strand = "-"
        if True:
            while True:
                rec = r.read_rec()
                if rec is None:
                    break
                if rec.flag & FUNMAP or rec.flag & FSECONDARY:
                    continue
                if rec.n_cigar > cfg.max_num_cigar or rec.n_cigar < 1:
                    continue
                if rec.mapq < cfg.min_mapping_quality:
                    continue
                ht = Hit(rec, hid)
                hid += 1
                ht.set_strand(sp.library_type)
                if ht.tid != bb1.tid or ht.pos > bb1.rpos + cfg.min_bundle_gap:
                    cnt += self._process(bb1, m)
                    bb1 = BundleBase()
                    bb1.strand = "+"
                if ht.tid != bb2.tid or ht.pos > bb2.rpos + cfg.min_bundle_gap:
                    cnt += self._process(bb2, m)
                    bb2 = BundleBase()
                    bb2.strand = "-"
                if cnt >= cfg.max_preview_reads:
                    break
                if cfg.uniquely_mapped_only and ht.nh != 1:
                    continue
                lt = sp.library_type
                if lt != UNSTRANDED and ht.strand == "+" and ht.xs == "-":
                    continue
                if lt != UNSTRANDED and ht.strand == "-" and ht.xs == "+":
                    continue
                if lt != UNSTRANDED and ht.strand == "." and ht.xs != ".":
                    ht.strand = ht.xs
                if lt != UNSTRANDED:
                    if ht.strand == "+":
                        bb1.add_hit_intervals(ht, rec)
                    if ht.strand == "-":
                        bb2.add_hit_intervals(ht, rec)
                else:
                    if ht.xs == ".":
                        bb1.add_hit_intervals(ht, rec)
                        ht2 = Hit(rec, ht.hid)
                        ht2.strand = ht.strand
                        bb2.add_hit_intervals(ht2, rec)
                    if ht.xs == "+":
                        bb1.add_hit_intervals(ht, rec)
                    if ht.xs == "-":
                        bb2.add_hit_intervals(ht, rec)
        return m

    def _process(self, bd, m):
        """previewer.cc:252-305"""
        cfg = self.cfg
        if len(bd.hits) < cfg.min_num_hits_in_bundle:
            return 0
        if len(bd.hits) > 20000:
            return 0
        if bd.tid < 0:
            return 0
        bd.build_fragments()
        gr = SpliceGraph()
        GraphBuilder(bd, cfg).build(gr)
        gr.build_vertex_index()
        vc = build_pereads_clusters(gr, bd, 2)
        cnt = 0
        for pc in vc:
            p1 = pc.extend[1]
            p2 = pc.extend[2]
            k1 = gr.locate_rbound(p1)
            k2 = gr.locate_lbound(p2)
            if k1 < 0 or k2 < 0 or k1 < k2:
                continue
            ok, chain = merge_intron_chains(pc.chain1, pc.chain2)
            if not ok:
                continue
            length = get_total_length_of_introns(chain)
            d = pc.bounds[3] - pc.bounds[0] - length
            cnt += 1
            m[d] = m.get(d, 0) + 1
            if cnt >= 1000:
                return cnt
        return cnt
