"""Alignment hits: strand assignment and fragment pairing keys.

A Hit is the assembler-facing slice of a BAM record (rnacore/hit.{h,cc}):
coordinates, flags, XS/HI/NH/NM tags, library-type-derived strand.
"""

from __future__ import annotations

from zlib import crc32

from ..constants import FR_FIRST, FR_SECOND
from ..io.bam import FPAIRED, FREAD1, FREAD2, FREVERSE


class Hit:
    __slots__ = ("hid", "tid", "pos", "rpos", "mpos", "mtid", "isize", "flag",
                 "qual", "qname", "strand", "xs", "ts", "hi", "nh", "nm",
                 "_qhash")

    def __init__(self, rec=None, hid=0):
        self.hid = hid
        self.strand = "."
        self._qhash = None
        if rec is None:
            return
        self.tid = rec.tid
        self.pos = rec.pos
        self.rpos = rec.rpos
        self.mpos = rec.mpos
        self.mtid = rec.mtid
        self.isize = rec.isize
        self.flag = rec.flag
        self.qual = rec.mapq
        self.qname = rec.qname
        self.xs = rec.xs
        self.ts = rec.ts
        self.hi = rec.hi
        self.nh = rec.nh
        self.nm = rec.nm

    def set_strand(self, libtype):
        """Library-type strand inference (rnacore/hit.cc:152-185)."""
        self.strand = strand_from_flag(self.flag, libtype)

    def clone(self):
        """Independent copy (bundles must not share mutable Hit objects)."""
        h = Hit.__new__(Hit)
        h.hid = self.hid
        h.tid = self.tid
        h.pos = self.pos
        h.rpos = self.rpos
        h.mpos = self.mpos
        h.mtid = self.mtid
        h.isize = self.isize
        h.flag = self.flag
        h.qual = self.qual
        h.qname = self.qname
        h.strand = self.strand
        h.xs = self.xs
        h.ts = self.ts
        h.hi = self.hi
        h.nh = self.nh
        h.nm = self.nm
        h._qhash = self._qhash
        return h

    def get_qhash(self):
        """Deterministic qname hash for mate-pair bucketing (hit.cc:217-220).

        crc32 is C-speed and process-stable; only intra-bundle consistency
        matters for pairing correctness."""
        h = self._qhash
        if h is None:
            h = crc32(self.qname.encode())
            self._qhash = h
        return h

    def __repr__(self):
        return "Hit(%s %d-%d %s)" % (self.qname, self.pos, self.rpos, self.strand)


def strand_from_flag(flag, libtype):
    """Library-type strand inference on a raw flag (rnacore/hit.cc:152-185)."""
    paired = (flag & FPAIRED) >= 1
    rev = (flag & FREVERSE) >= 1
    r1 = (flag & FREAD1) >= 1
    r2 = (flag & FREAD2) >= 1
    if libtype == FR_FIRST:
        if not paired:
            return "+" if rev else "-"
        if r1 and not r2:
            return "+" if rev else "-"
        if r2 and not r1:
            return "-" if rev else "+"
        return "."
    if libtype == FR_SECOND:
        if not paired:
            return "-" if rev else "+"
        if r1 and not r2:
            return "-" if rev else "+"
        if r2 and not r1:
            return "+" if rev else "-"
        return "."
    return "."


def hit_from_row(row, qnames, hid, qhash=None):
    """Build a Hit from a native-decoder fixed-layout row (io/bam_native.py);
    strand is left '.' — callers assign it from strand_from_flag.  qhash, if
    given, seeds the crc32 qname hash (the native scanner precomputes it)."""
    h = Hit.__new__(Hit)
    h.hid = hid
    h.tid = row[0]
    h.pos = row[1]
    h.rpos = row[2]
    h.qual = row[3]
    h.flag = row[4]
    h.mtid = row[5]
    h.mpos = row[6]
    h.isize = row[7]
    qoff = row[10]
    h.qname = qnames[qoff:qoff + row[11]].decode()
    h.strand = "."
    h.xs = chr(row[12])
    h.ts = "."
    h.hi = row[13]
    h.nh = row[14]
    h.nm = row[15]
    h._qhash = qhash
    return h
