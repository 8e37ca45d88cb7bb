"""Cross-bundle transcript merging.

Re-implements rnacore/transcript_set.{h,cc}: transcripts bucketed by
intron-chain hash; within a bucket, sorted merge-join using compare1.
Merge mode TRANSCRIPT_COUNT_ADD_COVERAGE_ADD adds coverage for multi-exon
(max for single-exon), unions per-sample copies and maintains
count2 = number of supporting samples.
"""

from __future__ import annotations

import copy

from ..constants import (TRANSCRIPT_COUNT_ADD_COVERAGE_ADD,
                         TRANSCRIPT_COUNT_ADD_COVERAGE_NUL)


class TransItem:
    """transcript_set.h trans_item"""
    __slots__ = ("trst", "count", "samples")

    def __init__(self, t=None, c=0, s=None):
        self.trst = t
        self.count = c
        self.samples = {}
        if t is not None:
            t.meta_tid = t.transcript_id
            if s is not None:
                tc = t.clone()
                self.samples[s] = tc
                for x in self.samples.values():
                    x.count2 = len(self.samples)

    def merge(self, ti: "TransItem", mode):
        """transcript_set.cc:38-81"""
        if mode == TRANSCRIPT_COUNT_ADD_COVERAGE_ADD:
            if len(self.trst.exons) >= 2:
                self.trst.coverage += ti.trst.coverage
            elif self.trst.coverage < ti.trst.coverage:
                self.trst.coverage = ti.trst.coverage
            self.trst.extend_bounds(ti.trst)
            self.count += ti.count
            self.trst.cov2 = max(self.trst.cov2, ti.trst.cov2)
            self.trst.conf = max(self.trst.conf, ti.trst.conf)
            self.trst.abd = max(self.trst.abd, ti.trst.abd)
            self.trst.count1 = max(self.trst.count1, ti.trst.count1)
            for sid, t in ti.samples.items():
                if sid not in self.samples:
                    self.samples[sid] = t
                else:
                    x = self.samples[sid]
                    x.cov2 = max(x.cov2, t.cov2)
                    x.conf = max(x.conf, t.conf)
                    x.abd = max(x.abd, t.abd)
                    x.count1 = max(x.count1, t.count1)
            # the reference propagates coverage/count2/meta_tid onto every
            # per-sample copy at every merge (transcript_set.cc:68-76) —
            # O(samples) per merge.  Those fields are only ever READ at
            # output time (incubator write_*_gtfs) and always hold the
            # final totals there, so propagation is deferred to one
            # sync_samples() pass before writing; merging itself reads
            # only the per-copy maxima maintained above.
            self.trst.count2 = len(self.samples)
        elif mode == TRANSCRIPT_COUNT_ADD_COVERAGE_NUL:
            self.count += ti.count
        else:
            raise AssertionError


def _merge_sorted_items(vx, vy, mode, overlap):
    """transcript_set.cc:83-120"""
    vz = []
    kx = ky = 0
    while kx < len(vx) and ky < len(vy):
        b = vx[kx].trst.compare1(vy[ky].trst, overlap)
        if b == 0:
            vx[kx].merge(vy[ky], mode)
            vz.append(vx[kx])
            kx += 1
            ky += 1
        elif b == 1:
            vz.append(vx[kx])
            kx += 1
        elif b == -1:
            vz.append(vy[ky])
            ky += 1
        else:
            raise AssertionError
    vz.extend(vx[kx:])
    vz.extend(vy[ky:])
    return vz


class TranscriptSet:
    def __init__(self, chrm, rid, single_exon_overlap):
        self.chrm = chrm
        self.rid = rid
        self.single_exon_overlap = single_exon_overlap
        self.mt = {}       # intron-chain hash -> list[TransItem]

    def add_transcript(self, t, count, sid, mode):
        """transcript_set.cc:149-154"""
        ts = TranscriptSet(t.seqname, self.rid, self.single_exon_overlap)
        h = t.get_intron_chain_hashing()
        ts.mt[h] = [TransItem(t, count, sid)]
        self.add(ts, mode)

    def add(self, ts: "TranscriptSet", mode):
        """transcript_set.cc:156-175"""
        if ts.chrm != self.chrm:
            return
        if ts.rid != self.rid and self.rid != -9:
            return
        for h, items in ts.mt.items():
            mine = self.mt.get(h)
            if mine is None:
                self.mt[h] = items
            else:
                self.mt[h] = _merge_sorted_items(mine, items, mode,
                                                 self.single_exon_overlap)

    def filter(self, min_count):
        for h in list(self.mt):
            self.mt[h] = [z for z in self.mt[h] if z.count >= min_count]

    def sync_samples(self):
        """Apply the per-sample-copy propagation the reference performs on
        every merge (transcript_set.cc:68-76) in one deferred pass: final
        meta coverage / supporting-sample count / meta_tid onto each copy.
        Must run before any reader of item.samples (output writers)."""
        for items in self.mt.values():
            for z in items:
                t = z.trst
                n = len(z.samples)
                t.count2 = n
                cov = t.coverage
                tid = t.transcript_id
                for x in z.samples.values():
                    x.coverage = cov
                    x.count2 = n
                    x.meta_tid = tid

    def get_transcripts(self, min_count=0):
        v = []
        for items in self.mt.values():
            for z in items:
                if z.count < min_count:
                    continue
                v.append(z.trst)
        return v

    def items(self):
        for items in self.mt.values():
            for z in items:
                yield z

    def clear(self):
        self.mt = {}
