"""Minimal native BAM reader/writer (no htslib dependency).

Replaces the htslib usage of the reference (rnacore/hit.cc, meta/generator.cc)
with an in-repo decoder: BGZF blocks via io.bgzf, alignment records decoded to
a light ``BamRec``.  CIGAR/flag semantics follow the SAM spec; splice sites
come from interior N operations exactly as hit::extract_splices
(rnacore/hit.cc:77-104).

The writer synthesizes valid BAMs for tests and benchmarks.
"""

from __future__ import annotations

import struct

from .bgzf import BgzfReader, BgzfWriter

# cigar op codes
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT, CHARD, CPAD, CEQUAL, CDIFF = range(9)
_CONSUME_REF = (1 << CMATCH) | (1 << CDEL) | (1 << CREF_SKIP) | (1 << CEQUAL) | (1 << CDIFF)
_CIGAR_CHARS = "MIDNSHP=X"
_CHAR2OP = {c: i for i, c in enumerate(_CIGAR_CHARS)}

FUNMAP = 0x4
FSECONDARY = 0x100
FPAIRED = 0x1
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FMUNMAP = 0x8


class BamHeader:
    def __init__(self, text="", names=None, lengths=None):
        self.text = text
        self.names = names or []
        self.lengths = lengths or []

    @property
    def n_targets(self):
        return len(self.names)


class BamRec:
    __slots__ = ("tid", "pos", "mapq", "flag", "l_seq", "mtid", "mpos",
                 "isize", "qname", "rpos", "xs", "ts", "hi", "nh",
                 "nm", "qual", "coords", "mcnt", "scnt", "icnt",
                 "_cigar", "_rawcig", "_rawoff", "_ncigar", "_totn")

    def __init__(self):
        self.xs = "."
        self.ts = "."
        self.hi = -1
        self.nh = -1
        self.nm = 0
        self.coords = None    # preparsed [match pairs | splices | indel pairs]
        self._cigar = None
        self._rawcig = None
        self._ncigar = None
        self._totn = None

    @property
    def cigar(self):
        if self._cigar is None and self._rawcig is not None:
            off = self._rawoff
            self._cigar = [(int(c) & 0xF, int(c) >> 4)
                           for c in self._rawcig[off:off + self._ncigar]]
        return self._cigar

    @cigar.setter
    def cigar(self, v):
        self._cigar = v

    def set_lazy_cigar(self, pool, off, n, totn):
        self._rawcig = pool
        self._rawoff = off
        self._ncigar = n
        self._totn = totn

    @property
    def n_cigar(self):
        if self._ncigar is not None:
            return self._ncigar
        return len(self._cigar) if self._cigar is not None else 0

    def ref_len(self):
        n = 0
        for op, ln in self.cigar:
            if (_CONSUME_REF >> op) & 1:
                n += ln
        return n

    def extract_splices(self):
        """Interior N ops -> [s1, e1, s2, e2, ...] (rnacore/hit.cc:77-104)."""
        if self.coords is not None:
            a = 2 * self.mcnt
            return self.coords[a:a + self.scnt]
        spos = []
        p = self.pos
        cig = self.cigar
        for k, (op, ln) in enumerate(cig):
            if (_CONSUME_REF >> op) & 1:
                p += ln
            if k == 0 or k == len(cig) - 1:
                continue
            if op != CREF_SKIP:
                continue
            spos.append(p - ln)
            spos.append(p)
        return spos

    def contain_splices(self):
        if self._totn is not None:
            return self._totn > 0
        return any(op == CREF_SKIP for op, _ in self.cigar)

    def match_intervals(self):
        """[(s, p)] for every CMATCH op (bundle_base::add_intervals)."""
        if self.coords is not None:
            c = self.coords
            return [(c[2 * i], c[2 * i + 1]) for i in range(self.mcnt)]
        out = []
        p = self.pos
        for op, ln in self.cigar:
            if (_CONSUME_REF >> op) & 1:
                p += ln
            if op == CMATCH:
                out.append((p - ln, p))
        return out

    def indel_intervals(self):
        """imap contributions: I -> [p-1,p+1), D -> [s,p)."""
        if self.coords is not None:
            c = self.coords
            a = 2 * self.mcnt + self.scnt
            return [(c[a + 2 * i], c[a + 2 * i + 1]) for i in range(self.icnt)]
        out = []
        p = self.pos
        for op, ln in self.cigar:
            if (_CONSUME_REF >> op) & 1:
                p += ln
            if op == CINS:
                out.append((p - 1, p + 1))
            elif op == CDEL:
                out.append((p - ln, p))
        return out


_REC_HEAD = struct.Struct("<iiBBHHHiiii")


class BamReader:
    def __init__(self, path):
        self._bgzf = BgzfReader(path)
        self.header = self._read_header()

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def _read_header(self):
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise IOError("bad BAM magic")
        l_text, = struct.unpack("<i", self._bgzf.read(4))
        text = self._bgzf.read(l_text).decode(errors="replace")
        n_ref, = struct.unpack("<i", self._bgzf.read(4))
        names, lengths = [], []
        for _ in range(n_ref):
            l_name, = struct.unpack("<i", self._bgzf.read(4))
            names.append(self._bgzf.read(l_name)[:-1].decode())
            lengths.append(struct.unpack("<i", self._bgzf.read(4))[0])
        return BamHeader(text, names, lengths)

    def tell(self):
        return self._bgzf.tell()

    def seek(self, voffset):
        self._bgzf.seek(voffset)

    def read_rec(self):
        """Decode the next alignment record; None at EOF."""
        raw = self._bgzf.read(4)
        if len(raw) < 4:
            return None
        block_size, = struct.unpack("<i", raw)
        data = self._bgzf.read(block_size)
        if len(data) < block_size:
            return None
        (refID, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         next_refID, next_pos, tlen) = _REC_HEAD.unpack_from(data, 0)
        off = 32
        rec = BamRec()
        rec.tid = refID
        rec.pos = pos
        rec.mapq = mapq
        rec.qual = mapq
        rec.flag = flag
        rec.l_seq = l_seq
        rec.mtid = next_refID
        rec.mpos = next_pos
        rec.isize = tlen
        rec.qname = data[off:off + l_read_name - 1].decode()
        off += l_read_name
        cigar = []
        for k in range(n_cigar):
            c, = struct.unpack_from("<I", data, off)
            cigar.append((c & 0xF, c >> 4))
            off += 4
        rec.cigar = cigar
        rec.rpos = pos + rec.ref_len()
        off += (l_seq + 1) // 2 + l_seq
        self._parse_tags(rec, data, off)
        return rec

    @staticmethod
    def _parse_tags(rec, data, off):
        """Extract XS/ts/HI/NH/NM/nM aux tags (hit::set_tags)."""
        n = len(data)
        while off + 3 <= n:
            tag = data[off:off + 2]
            typ = chr(data[off + 2])
            off += 3
            if typ == "A":
                val = chr(data[off]); off += 1
            elif typ in "cC":
                val = data[off] if typ == "C" else struct.unpack_from("<b", data, off)[0]
                off += 1
            elif typ in "sS":
                val = struct.unpack_from("<h" if typ == "s" else "<H", data, off)[0]
                off += 2
            elif typ in "iI":
                val = struct.unpack_from("<i" if typ == "i" else "<I", data, off)[0]
                off += 4
            elif typ == "f":
                val = struct.unpack_from("<f", data, off)[0]
                off += 4
            elif typ in "ZH":
                end = data.index(b"\x00", off)
                val = data[off:end].decode()
                off = end + 1
            elif typ == "B":
                sub = chr(data[off]); cnt = struct.unpack_from("<i", data, off + 1)[0]
                sz = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                off += 5 + cnt * sz
                continue
            else:
                break
            t = tag.decode()
            if t == "XS" and typ == "A":
                rec.xs = val
            elif t == "ts" and typ == "A":
                rec.ts = val
            elif t == "HI":
                rec.hi = int(val)
            elif t == "NH":
                rec.nh = int(val)
            elif t in ("NM", "nM"):
                rec.nm = int(val)
        # ts -> xs conversion (hit.cc:116-123)
        if rec.xs == "." and rec.ts != ".":
            rev = (rec.flag & FREVERSE) != 0
            if rec.ts == "+":
                rec.xs = "-" if rev else "+"
            elif rec.ts == "-":
                rec.xs = "+" if rev else "-"


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
