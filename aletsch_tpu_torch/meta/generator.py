"""Per-(sample, target, region) BAM scan producing bundles.

Re-implements meta/generator.{h,cc}: seek to the region's recorded virtual
offset, stream records with the reference's filters (unmapped / secondary /
cigar count / quality / span / consecutive duplicates), split into '+' and
'-' bundle streams on >= min_bundle_gap coverage gaps, route unstranded
unspliced reads to both strands, and finalize bundles (flush splices, skip
splice-free bundles when configured).
"""

from __future__ import annotations

from ..constants import UNSTRANDED
from ..core.hits import Hit, hit_from_row, strand_from_flag
from ..io.bam import FSECONDARY, FUNMAP
from ..io.bam_native import open_bam
from .bundle import Bundle


class Generator:
    def __init__(self, sp, vcb, cfg, target_id, region_id,
                 region_id_last=None):
        self.sp = sp
        self.vcb = vcb
        self.cfg = cfg
        self.target_id = target_id
        self.region_id = region_id
        # merged multi-region scan (incubator _generate_sample_block):
        # one seek + one native pass covers [region_id, region_id_last];
        # region tables are gap-aligned so records partition exactly and
        # the caller splits the bundle stream by lpos
        self.region_id_last = region_id if region_id_last is None \
            else region_id_last
        self.index = 0

    def resolve(self):
        """meta/generator.cc:51-201"""
        sp = self.sp
        tid = self.target_id
        rid = self.region_id
        if tid < 0 or rid < 0:
            return
        from ..io.bam_native import open_bam_cached
        r = open_bam_cached(sp.align_file)
        if r is not None and hasattr(r, "scan_region"):
            # thread-cached reader; do not close (reused across regions)
            return self._resolve_scan(r)
        with open_bam(sp.align_file) as r:
            if hasattr(r, "scan_region"):
                return self._resolve_scan(r)
            if hasattr(r, "read_batch_arrays"):
                return self._resolve_batched(r)
            return self._resolve_slow(r)

    def _resolve_scan(self, r):
        """Native scan: the filter/route/split loop runs in C++
        (native/abam.cpp abam_scan_next); Python materializes each flushed
        bundle with bulk coverage-map builds."""
        from ..core.bundle import materialize_bundle
        from ..io.bam_native import scan_params
        from .native_core import native_core_available
        sp = self.sp
        cfg = self.cfg
        tid = self.target_id
        rid = self.region_id
        # light bundles carry only the scanner arrays + grouping fields;
        # the native assembly core consumes them whole (meta/native_core.py)
        light = native_core_available() and cfg.verbose < 2
        pr = scan_params(cfg, sp.library_type)
        if light and hasattr(r, "scan_region_raw"):
            return self._resolve_scan_fused(r, pr)
        # pre-materialization drop: _generate discards tid < 0 and (when
        # skip_single_exon_transcripts) splice-free bundles — both are
        # decidable from the scanner's flush fields, so don't build the
        # coverage maps for them (the scanner's splices are the same
        # sorted-unique set _generate would derive)
        skip_se = cfg.skip_single_exon_transcripts
        for chunk in r.scan_region(tid, sp.end1[tid][self.region_id_last],
                                   sp.start_off[tid][rid], pr,
                                   need_qnames=not light):
            for sb in chunk:
                if sb.tid < 0:
                    continue
                if skip_se and len(sb.splices) == 0:
                    continue
                self._generate(materialize_bundle(sb, light=light))

    def _resolve_scan_fused(self, r, pr):
        """Light-bundle fast path: build the final meta Bundle straight
        from the raw scanner chunk pools — one object and one __dict__ per
        bundle instead of the ScanBundle -> BundleBase -> Bundle triple
        construction.  Field-for-field identical to
        materialize_bundle(light=True) + _generate + compute_strand."""
        from ..core.chain_set import ChainSet
        from ..utils.intervals import CoverageMap
        from ..constants import UNSTRANDED
        from .bundle import Bundle
        sp = self.sp
        cfg = self.cfg
        tn = sp.target_names
        vcb = self.vcb
        skip_se = cfg.skip_single_exon_transcripts
        unstranded = sp.library_type == UNSTRANDED
        sid = sp.sample_id
        new_b = Bundle.__new__
        from .native_core import _cfg_index
        cfg_idx = _cfg_index(cfg)
        ins_lo = sp.insertsize_low
        ins_hi = sp.insertsize_high
        for (nb, mlist, fixed, coords, mev, iev, frgs, splices, ptrs) in \
                r.scan_region_raw(self.target_id,
                                  sp.end1[self.target_id]
                                  [self.region_id_last],
                                  sp.start_off[self.target_id]
                                  [self.region_id], pr):
            p_fix, p_co, p_me, p_ie, p_fr = ptrs
            strands = fixed[:, 22]
            ro = co2 = mo = io = fo = so = 0
            for b in range(nb):
                (ms, mtid, mlpos, mrpos, n, ql, cl, ml, il,
                 mepoch, fl, sl, xsp, xsm) = mlist[b]
                if mtid < 0 or (skip_se and sl == 0):
                    ro += n; co2 += cl; mo += ml
                    io += il; fo += fl; so += sl
                    continue
                # bundle strand: first routed hit strand, vote-overridden
                # for unstranded libraries (bundle_base.cc:206-224)
                if unstranded:
                    st = "+" if xsp > xsm else ("-" if xsp < xsm else ".")
                else:
                    st = chr(strands[ro]) if n else "."
                mmap = CoverageMap()
                imap = CoverageMap()
                mv = mev[mo:mo + ml]
                iv = iev[io:io + il]
                if ml:
                    mmap._chunks.append(mv.reshape(-1, 2))
                    mmap._dirty = True
                if il:
                    imap._chunks.append(iv.reshape(-1, 2))
                    imap._dirty = True
                spl = splices[so:so + sl]
                bd = new_b(Bundle)
                bd.__dict__ = {
                    "tid": mtid, "chrm": tn[mtid],
                    "lpos": mlpos, "rpos": mrpos, "strand": st,
                    "hits": [], "frgs": [],
                    "frgs_ready": True, "_frgs_mutated": False,
                    "splices": spl.tolist(),
                    "hcst": ChainSet(), "fcst": ChainSet(),
                    "mmap": mmap, "imap": imap,
                    "_light": True, "_xs_pm": (xsp, xsm),
                    "_splices_arr": spl,
                    "_scan_fixed": fixed[ro:ro + n],
                    "_scan_coords": coords[co2:co2 + cl],
                    "_scan_mev": mv, "_scan_iev": iv,
                    "_scan_frgs": frgs[fo:fo + fl],
                    "_scan_ptrs": (p_fix + 100 * ro, p_co + 4 * co2,
                                   p_me + 4 * mo, p_ie + 4 * io,
                                   p_fr + 4 * fo),
                    "_scan_cnts": (n, ml // 2, il // 2, fl // 2),
                    # one flat record for the vectorized batch marshal
                    # (native_core._marshal_batch fast path): 5 ptrs,
                    # 4 counts, lpos, rpos, strand, sid, ins_lo/hi,
                    # native-cfg index
                    "_scan_rec": (p_fix + 100 * ro, p_co + 4 * co2,
                                  p_me + 4 * mo, p_ie + 4 * io,
                                  p_fr + 4 * fo, n, ml // 2, il // 2,
                                  fl // 2, mlpos, mrpos, ord(st), sid,
                                  ins_lo, ins_hi, cfg_idx),
                    "cfg": cfg, "sp": sp, "num_combined": 0,
                    "gid": "gene.%d.%d" % (sid, self.index),
                }
                vcb.append(bd)
                self.index += 1
                ro += n; co2 += cl; mo += ml
                io += il; fo += fl; so += sl

    def _resolve_batched(self, r):
        """Columnar scan: filters and dedup are computed on the decoder's
        flat arrays; Hit objects are built only for surviving records."""
        import numpy as np
        sp = self.sp
        cfg = self.cfg
        tid = self.target_id
        rid = self.region_id
        end1 = sp.end1[tid][self.region_id_last]
        offt = sp.start_off[tid][rid]
        lt = sp.library_type
        unstranded = lt == UNSTRANDED

        from ..core.bundle import BundleBase
        bb1 = BundleBase()
        bb2 = BundleBase()
        hid = 0
        pre_lpos = pre_rpos = -1
        r.seek(offt)
        done = False
        while not done:
            b = r.read_batch_arrays()
            if b is None:
                break
            f = b.fixed
            # stop conditions: off-region or off-chromosome
            stop = (f[:, 1] >= end1) | (f[:, 0] != tid)
            nstop = np.nonzero(stop)[0]
            limit = f.shape[0]
            if nstop.size:
                limit = int(nstop[0])
                done = True
            if limit == 0:
                break
            f = f[:limit]
            keep = ((f[:, 4] & FUNMAP) == 0) & \
                (f[:, 8] <= cfg.max_num_cigar) & (f[:, 8] >= 1) & \
                (f[:, 3] >= cfg.min_mapping_quality) & \
                (np.abs(f[:, 1] - f[:, 2]) < cfg.max_read_span)
            if not cfg.use_second_alignment:
                keep &= (f[:, 4] & FSECONDARY) == 0
            # mate-span filter only for paired reads with a mapped mate
            # (generator.cc:95 applies it to any read with 0x8 unset, which
            # drops single-end/long reads past max_read_span; divergence
            # documented in docs/DESIGN.md; ALETSCH_REF_QUIRKS replicates
            # the reference exactly for byte-parity runs)
            import os as _os
            if _os.environ.get("ALETSCH_REF_QUIRKS") == "1":
                paired_mate = (f[:, 4] & 0x8) == 0
            else:
                paired_mate = ((f[:, 4] & 0x1) != 0) & ((f[:, 4] & 0x8) == 0)
            keep &= ~paired_mate | (np.abs(f[:, 1] - f[:, 6]) < cfg.max_read_span)
            idx = np.nonzero(keep)[0]
            if idx.size == 0:
                continue
            ff = f[idx]
            # consecutive-duplicate collapse among surviving records
            dup = np.zeros(idx.size, dtype=bool)
            dup[1:] = (ff[1:, 1] == ff[:-1, 1]) & (ff[1:, 2] == ff[:-1, 2])
            if pre_lpos >= 0:
                dup[0] = ff[0, 1] == pre_lpos and ff[0, 2] == pre_rpos
            pre_lpos = int(ff[-1, 1])
            pre_rpos = int(ff[-1, 2])
            idx = idx[~dup]
            if idx.size == 0:
                continue
            rows = f[idx].tolist()
            for row in rows:
                rtid, rpos = row[0], row[1]
                rhid = hid
                hid += 1
                if bb1.hits and (rtid != bb1.tid or rpos > bb1.rpos + cfg.min_bundle_gap):
                    self._generate(bb1)
                    bb1 = BundleBase()
                if bb2.hits and (rtid != bb2.tid or rpos > bb2.rpos + cfg.min_bundle_gap):
                    self._generate(bb2)
                    bb2 = BundleBase()

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
                elif xs == "." and row[21] != 0:
                    continue                 # spliced, no XS: dropped below
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
                    else:                    # no N ops: unspliced
                        bb1.add_hit_parsed(ht, coords, mcnt, scnt, icnt)
                        bb2.add_hit_parsed(ht.clone(), coords, mcnt,
                                           scnt, icnt)
        self._generate(bb1)
        self._generate(bb2)

    def _resolve_slow(self, r):
        sp = self.sp
        cfg = self.cfg
        tid = self.target_id
        rid = self.region_id
        end1 = sp.end1[tid][self.region_id_last]
        offt = sp.start_off[tid][rid]

        from ..core.bundle import BundleBase
        bb1 = BundleBase()
        bb2 = BundleBase()
        hid = 0
        pre_lpos = pre_rpos = -1

        if True:
            r.seek(offt)
            while True:
                rec = r.read_rec()
                if rec is None:
                    break
                if rec.pos >= end1:
                    break
                if rec.tid != tid:
                    break
                if rec.flag & FUNMAP:
                    continue
                if (rec.flag & FSECONDARY) and not cfg.use_second_alignment:
                    continue
                if rec.n_cigar > cfg.max_num_cigar:
                    continue
                if rec.mapq < cfg.min_mapping_quality:
                    continue
                if rec.n_cigar < 1:
                    continue
                ht = Hit(rec, hid)
                hid += 1
                if abs(ht.pos - ht.rpos) >= cfg.max_read_span:
                    continue
                import os as _os
                if ((rec.flag & 0x1)
                        or _os.environ.get("ALETSCH_REF_QUIRKS") == "1") \
                        and (rec.flag & 0x8) == 0 and \
                        abs(ht.pos - ht.mpos) >= cfg.max_read_span:
                    continue
                if ht.pos == pre_lpos and ht.rpos == pre_rpos:
                    continue
                pre_lpos, pre_rpos = ht.pos, ht.rpos
                ht.set_strand(sp.library_type)

                # truncate on gaps
                if bb1.hits and (ht.tid != bb1.tid or ht.pos > bb1.rpos + cfg.min_bundle_gap):
                    self._generate(bb1)
                    bb1 = BundleBase()
                if bb2.hits and (ht.tid != bb2.tid or ht.pos > bb2.rpos + cfg.min_bundle_gap):
                    self._generate(bb2)
                    bb2 = BundleBase()

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
                    if ht.xs == "+":
                        bb1.add_hit_intervals(ht, rec)
                    elif ht.xs == "-":
                        bb2.add_hit_intervals(ht, rec)
                    elif not rec.contain_splices():
                        bb1.add_hit_intervals(ht, rec)
                        ht2 = Hit(rec, ht.hid)
                        ht2.strand = ht.strand
                        bb2.add_hit_intervals(ht2, rec)

        self._generate(bb1)
        self._generate(bb2)

    def _generate(self, bb):
        """meta/generator.cc:203-227"""
        if bb.tid < 0:
            return
        bb.chrm = self.sp.target_names[bb.tid]
        if not getattr(bb, "_light", False):
            bb.splices = bb.hcst.get_splices()
        if self.cfg.skip_single_exon_transcripts and len(bb.splices) <= 0:
            return
        bd = Bundle(self.cfg, self.sp, bb)
        bd.gid = "gene.%d.%d" % (self.sp.sample_id, self.index)
        bd.compute_strand(self.sp.library_type)
        self.vcb.append(bd)
        self.index += 1
