"""BAM writer: frozen copy of aletsch_tpu_torch/io/bam.py's BamWriter,
parse_cigar and the constants they use."""

from __future__ import annotations

import struct

from .bgzf import BgzfWriter

# cigar op codes
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT, CHARD, CPAD, CEQUAL, CDIFF = range(9)
_CIGAR_CHARS = "MIDNSHP=X"
_CHAR2OP = {c: i for i, c in enumerate(_CIGAR_CHARS)}

_REC_HEAD = struct.Struct("<iiBBHHHiiii")


class BamWriter:
    """Writes synthetic BAMs for tests/benchmarks."""

    def __init__(self, path, names, lengths, text=""):
        self._bgzf = BgzfWriter(path)
        if not text:
            text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                "@SQ\tSN:%s\tLN:%d\n" % (n, l) for n, l in zip(names, lengths))
        tb = text.encode()
        out = [b"BAM\x01", struct.pack("<i", len(tb)), tb,
               struct.pack("<i", len(names))]
        for n, l in zip(names, lengths):
            nb = n.encode() + b"\x00"
            out += [struct.pack("<i", len(nb)), nb, struct.pack("<i", l)]
        self._bgzf.write(b"".join(out))

    def write_rec(self, qname, flag, tid, pos, mapq, cigar, mtid=-1, mpos=-1,
                  isize=0, xs=None, nh=None, hi=None, nm=None):
        """cigar: list of (op, len) or a cigar string like '50M100N50M'."""
        if isinstance(cigar, str):
            cigar = parse_cigar(cigar)
        qb = qname.encode() + b"\x00"
        aux = b""
        if xs is not None and xs != ".":
            aux += b"XSA" + xs.encode()
        if nh is not None:
            aux += b"NHi" + struct.pack("<i", nh)
        if hi is not None:
            aux += b"HIi" + struct.pack("<i", hi)
        if nm is not None:
            aux += b"NMi" + struct.pack("<i", nm)
        body = _REC_HEAD.pack(tid, pos, len(qb), mapq, 0, len(cigar), flag,
                              0, mtid, mpos, isize)
        body += qb
        for op, ln in cigar:
            body += struct.pack("<I", (ln << 4) | op)
        body += aux
        self._bgzf.write(struct.pack("<i", len(body)) + body)

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def parse_cigar(s):
    out = []
    num = 0
    for ch in s:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            out.append((_CHAR2OP[ch], num))
            num = 0
    return out
