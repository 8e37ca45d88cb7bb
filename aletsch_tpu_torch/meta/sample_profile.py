"""Per-sample state: library/insert-size profile and region partition tables.

Re-implements rnacore/sample_profile.{h,cc}: profile save/load as key-value
text ``<dir>/<sid>.profile`` and ``set_batch_boundaries`` — one sequential
BAM sweep recording the BGZF virtual offset and first-read positions for each
``region_partition_length`` slot ending at a >= min_bundle_gap coverage gap
(sample_profile.cc:167-252).
"""

from __future__ import annotations

import os

from ..constants import DEFAULT, PAIRED_END, UNSTRANDED
from ..io.bam import FUNMAP
from ..io.bam_native import open_bam


class SampleProfile:
    def __init__(self, sample_id, region_partition_length):
        self.sample_id = sample_id
        self.align_file = ""
        self.index_file = ""
        self.data_type = DEFAULT
        self.region_partition_length = region_partition_length
        self.library_type = UNSTRANDED
        self.bam_with_xs = 0
        self.num_xs = 0
        self.spn = 0
        self.insert_total = 0
        self.insertsize_low = 80
        self.insertsize_high = 500
        self.insertsize_median = 250
        self.insertsize_ave = 0.0
        self.insertsize_std = 0.0
        # per-target partition tables
        self.start1 = []
        self.start2 = []
        self.start_off = []
        self.end1 = []
        self.end2 = []
        self.target_names = []
        self.target_lengths = []

    # -------------------------------------------------------------- profiles
    def profile_path(self, d):
        return os.path.join(d, "%d.profile" % self.sample_id)

    def save_profile(self, d):
        """sample_profile.cc:68-93"""
        with open(self.profile_path(d), "w") as fout:
            fout.write("library_type %d\n" % self.library_type)
            fout.write("bam_with_xs %d\n" % self.bam_with_xs)
            if self.data_type == PAIRED_END:
                fout.write("insertsize_low %d\n" % self.insertsize_low)
                fout.write("insertsize_high %d\n" % self.insertsize_high)
                fout.write("insertsize_median %d\n" % self.insertsize_median)
                fout.write("insertsize_ave %g\n" % self.insertsize_ave)
                fout.write("insertsize_std %g\n" % self.insertsize_std)

    def load_profile(self, d):
        """sample_profile.cc:36-66"""
        path = self.profile_path(d)
        if not os.path.exists(path):
            return False
        conv = {
            "library_type": ("library_type", int),
            "bam_with_xs": ("bam_with_xs", int),
            "insertsize_low": ("insertsize_low", lambda x: int(float(x))),
            "insertsize_high": ("insertsize_high", lambda x: int(float(x))),
            "insertsize_median": ("insertsize_median", lambda x: int(float(x))),
            "insertsize_ave": ("insertsize_ave", float),
            "insertsize_std": ("insertsize_std", float),
        }
        with open(path) as fin:
            for line in fin:
                parts = line.split()
                if len(parts) < 2:
                    continue
                c = conv.get(parts[0])
                if c is None:
                    continue
                setattr(self, c[0], c[1](parts[1]))
        return True

    # ------------------------------------------------- region-table sidecar
    # The reference recomputes set_batch_boundaries on every run (it has one
    # long-lived process); our multi-process path (--jobs / --shard) would
    # repeat the full-BAM sweep per worker, so the tables are cached next to
    # the profile as ``<sid>.regions.npz``, keyed on the sweep parameters and
    # the BAM size so stale caches miss.
    def regions_path(self, d):
        return os.path.join(d, "%d.regions.npz" % self.sample_id)

    def _regions_key(self, min_bundle_gap, max_read_span):
        try:
            sz = os.path.getsize(self.align_file)
        except OSError:
            sz = -1
        return [self.region_partition_length, min_bundle_gap,
                max_read_span, sz]

    def save_regions(self, d, min_bundle_gap, max_read_span):
        import numpy as np
        arrs = {
            "meta": np.array(self._regions_key(min_bundle_gap, max_read_span),
                             dtype=np.int64),
            "names": np.array(self.target_names),
            "lengths": np.array(self.target_lengths, dtype=np.int64),
        }
        for i in range(len(self.target_names)):
            arrs["t%d" % i] = np.array(
                [self.start1[i], self.start2[i], self.start_off[i],
                 self.end1[i], self.end2[i]], dtype=np.int64)
        path = self.regions_path(d)
        tmp = path + ".tmp.%d" % os.getpid()
        np.savez(tmp, **arrs)
        # np.savez appends .npz when missing
        os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)

    def load_regions(self, d, min_bundle_gap, max_read_span):
        import numpy as np
        path = self.regions_path(d)
        if not os.path.exists(path):
            return False
        try:
            z = np.load(path, allow_pickle=False)
            if z["meta"].tolist() != \
                    self._regions_key(min_bundle_gap, max_read_span):
                return False
            names = [str(x) for x in z["names"]]
            lengths = z["lengths"].tolist()
            s1, s2, so, e1, e2 = [], [], [], [], []
            for i in range(len(names)):
                t = z["t%d" % i]
                s1.append(t[0].tolist())
                s2.append(t[1].tolist())
                so.append(t[2].tolist())
                e1.append(t[3].tolist())
                e2.append(t[4].tolist())
        except Exception:
            return False
        self.target_names = names
        self.target_lengths = lengths
        self.start1, self.start2, self.start_off = s1, s2, so
        self.end1, self.end2 = e1, e2
        return True

    # -------------------------------------------------- region partitioning
    def set_batch_boundaries(self, min_bundle_gap, max_read_span):
        """One linear sweep recording per-region seek offsets
        (sample_profile.cc:167-252).  Also closes the final open region,
        which the reference leaves implicitly terminated at EOF.

        Uses the native batch decoder's flat arrays when available: the
        scan is vectorized per batch, touching Python only at coverage
        gaps and chromosome changes.

        ALETSCH_REF_QUIRKS=1 replicates the reference binary's two
        region-table quirks byte-for-byte for golden comparison runs
        (tools/refbuild/compare.py): offsets recorded AFTER each region's
        first read (so that read is dropped, sample_profile.cc:214-217)
        and the final region of the final target left unclosed (end1
        stays 0, so it is skipped; sample_profile.cc:167-252)."""
        import os
        if os.environ.get("ALETSCH_REF_QUIRKS") != "1" and \
                getattr(self, "_preview_regions", None) == \
                (min_bundle_gap, max_read_span):
            return      # region grid captured on the preview decode pass
        with open_bam(self.align_file) as r:
            if os.environ.get("ALETSCH_REF_QUIRKS") == "1":
                return self._set_batch_boundaries_quirks(
                    r, min_bundle_gap, max_read_span)
            if hasattr(r, "read_batch_arrays"):
                return self._set_batch_boundaries_batched(
                    r, min_bundle_gap, max_read_span)
            return self._set_batch_boundaries_slow(
                r, min_bundle_gap, max_read_span)

    def _init_tables(self, hdr):
        self.target_names = list(hdr.names)
        self.target_lengths = list(hdr.lengths)
        self.start1 = []
        self.start2 = []
        self.start_off = []
        self.end1 = []
        self.end2 = []
        for i in range(hdr.n_targets):
            n = hdr.lengths[i] // self.region_partition_length + 1
            self.start1.append([0] * n)
            self.start2.append([0] * n)
            self.start_off.append([0] * n)
            self.end1.append([0] * n)
            self.end2.append([0] * n)

    def _set_batch_boundaries_batched(self, r, min_bundle_gap, max_read_span):
        import numpy as np
        self._init_tables(r.header)
        rl = self.region_partition_length
        tid = -1
        rid = 0
        rpos = 0
        while True:
            b = r.read_batch_arrays()
            if b is None:
                break
            f = b.fixed
            mask = ((f[:, 4] & 0x4) == 0) & \
                (np.abs(f[:, 1] - f[:, 2]) < max_read_span)
            idx = np.nonzero(mask)[0]
            if idx.size == 0:
                continue
            tids = f[idx, 0]
            poss = f[idx, 1]
            rposs = f[idx, 2]
            voffs = b.voffs[idx]
            # split the batch into per-chromosome segments (changes are rare)
            cuts = [0] + (np.nonzero(tids[1:] != tids[:-1])[0] + 1).tolist() \
                + [idx.size]
            for si in range(len(cuts) - 1):
                a, z = cuts[si], cuts[si + 1]
                t = int(tids[a])
                if t != tid:
                    if tid >= 0:
                        self.end1[tid][rid] = rpos
                        self.end2[tid][rid] = rpos
                    tid = t
                    rid = 0
                    self.start1[tid][rid] = int(poss[a])
                    self.start2[tid][rid] = int(rposs[a])
                    self.start_off[tid][rid] = int(voffs[a])
                    rpos = int(rposs[a])
                seg_r = rposs[a:z]
                seg_p = poss[a:z]
                runmax = np.maximum.accumulate(seg_r)
                prevmax = np.empty_like(runmax)
                prevmax[0] = rpos
                if z - a > 1:
                    prevmax[1:] = np.maximum(runmax[:-1], rpos)
                # candidate gap rows (region switches only happen here)
                for k in np.nonzero(seg_p > prevmax + min_bundle_gap)[0].tolist():
                    p = int(seg_p[k])
                    if p >= rl * (1 + rid):
                        pm = int(prevmax[k])
                        self.end1[tid][rid] = pm
                        self.end2[tid][rid] = pm
                        rid = p // rl
                        self.start1[tid][rid] = p
                        self.start2[tid][rid] = int(seg_r[k])
                        self.start_off[tid][rid] = int(voffs[a + k])
                rpos = max(rpos, int(runmax[-1]))
        if tid >= 0:
            self.end1[tid][rid] = rpos
            self.end2[tid][rid] = rpos

    def _set_batch_boundaries_quirks(self, r, min_bundle_gap,
                                     max_read_span):
        """Reference-exact region tables (see set_batch_boundaries): the
        recorded offset is the position AFTER the region's first read
        (bgzf_tell called post-sam_read1, sample_profile.cc:214-217) and
        the final region of the final target is never closed."""
        self._init_tables(r.header)
        tid = -1
        rid = 0
        rpos = 0
        while True:
            rec = r.read_rec()
            if rec is None:
                break
            voff = r.tell()          # after the read, like the reference
            if rec.flag & FUNMAP:
                continue
            if abs(rec.pos - rec.rpos) >= max_read_span:
                continue
            if rec.tid != tid:
                if tid >= 0:
                    self.end1[tid][rid] = rpos
                    self.end2[tid][rid] = rpos
                tid = rec.tid
                rid = 0
                self.start1[tid][rid] = rec.pos
                self.start2[tid][rid] = rec.rpos
                self.start_off[tid][rid] = voff
                rpos = rec.rpos
            if rec.pos > rpos + min_bundle_gap:
                if rec.pos >= self.region_partition_length * (1 + rid):
                    self.end1[tid][rid] = rpos
                    self.end2[tid][rid] = rpos
                    rid = rec.pos // self.region_partition_length
                    self.start1[tid][rid] = rec.pos
                    self.start2[tid][rid] = rec.rpos
                    self.start_off[tid][rid] = voff
            if rec.rpos > rpos:
                rpos = rec.rpos
        # reference quirk: the final region of the final target stays
        # unclosed (end1 == 0 -> skipped by generate_merge_assemble)

    def _set_batch_boundaries_slow(self, r, min_bundle_gap, max_read_span):
        if True:
            self._init_tables(r.header)
            tid = -1
            rid = 0
            rpos = 0
            while True:
                voff = r.tell()
                rec = r.read_rec()
                if rec is None:
                    break
                if rec.flag & FUNMAP:
                    continue
                if abs(rec.pos - rec.rpos) >= max_read_span:
                    continue
                if rec.tid != tid:
                    if tid >= 0:
                        self.end1[tid][rid] = rpos
                        self.end2[tid][rid] = rpos
                    tid = rec.tid
                    rid = 0
                    self.start1[tid][rid] = rec.pos
                    self.start2[tid][rid] = rec.rpos
                    self.start_off[tid][rid] = voff
                    rpos = rec.rpos
                if rec.pos > rpos + min_bundle_gap:
                    if rec.pos >= self.region_partition_length * (1 + rid):
                        self.end1[tid][rid] = rpos
                        self.end2[tid][rid] = rpos
                        rid = rec.pos // self.region_partition_length
                        self.start1[tid][rid] = rec.pos
                        self.start2[tid][rid] = rec.rpos
                        self.start_off[tid][rid] = voff
                if rec.rpos > rpos:
                    rpos = rec.rpos
            if tid >= 0:
                self.end1[tid][rid] = rpos
                self.end2[tid][rid] = rpos
