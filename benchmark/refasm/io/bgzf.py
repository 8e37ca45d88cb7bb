"""BGZF block-gzip reader/writer with virtual offsets.

The reference random-accesses BAMs by recording BGZF virtual offsets during a
single linear sweep (rnacore/sample_profile.cc:167-252) and later seeking with
bgzf_seek (meta/generator.cc:74).  We implement the same access pattern on top
of zlib: a virtual offset packs (compressed_block_offset << 16 | within_block
offset), so region readers can jump straight to a recorded block.
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HDR = struct.Struct("<BBBBIBBHH")  # gzip header with XLEN


class BgzfReader:
    """Sequential + seekable BGZF reader."""

    def __init__(self, path):
        self._fh = open(path, "rb")
        self._block_start = 0     # compressed offset of current block
        self._buf = b""           # decompressed current block
        self._pos = 0             # position within _buf
        self._load_block()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -------------------------------------------------------------- internals
    def _load_block(self) -> bool:
        self._block_start = self._fh.tell()
        hdr = self._fh.read(12)
        if len(hdr) < 12:
            self._buf = b""
            self._pos = 0
            return False
        magic1, magic2, method, flags, _mtime, _xfl, _os, xlen = \
            struct.unpack("<BBBBIBBH", hdr)
        if magic1 != 0x1F or magic2 != 0x8B:
            raise IOError("not a BGZF stream")
        extra = self._fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack("<H", extra[i + 2:i + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[i + 4:i + 6])[0] + 1
            i += 4 + slen
        if bsize is None:
            raise IOError("missing BGZF BC subfield")
        cdata_len = bsize - 12 - xlen - 8
        cdata = self._fh.read(cdata_len)
        self._fh.read(8)  # crc32 + isize
        self._buf = zlib.decompress(cdata, -15) if cdata_len > 0 else b""
        self._pos = 0
        return True

    # ------------------------------------------------------------------- API
    def tell(self) -> int:
        """Virtual offset of the *next* byte to be read."""
        if self._pos >= len(self._buf):
            # next read starts a new block at the current file position
            return self._fh.tell() << 16
        return (self._block_start << 16) | self._pos

    def seek(self, voffset: int):
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        self._fh.seek(coffset)
        if not self._load_block():
            return
        self._pos = uoffset

    def read(self, n: int) -> bytes:
        out = []
        need = n
        while need > 0:
            if self._pos >= len(self._buf):
                if not self._load_block():
                    break
                if len(self._buf) == 0:
                    # EOF block
                    break
            take = min(need, len(self._buf) - self._pos)
            out.append(self._buf[self._pos:self._pos + take])
            self._pos += take
            need -= take
        return b"".join(out)


class BgzfWriter:
    """BGZF writer used for synthesizing test/bench BAMs."""

    def __init__(self, path, block_size=60000):
        self._fh = open(path, "wb")
        self._block_size = block_size
        self._pending = bytearray()

    def write(self, data: bytes):
        self._pending.extend(data)
        while len(self._pending) >= self._block_size:
            self._flush_block(self._block_size)

    def _flush_block(self, n):
        chunk = bytes(self._pending[:n])
        del self._pending[:n]
        comp = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = comp.compress(chunk) + comp.flush()
        bsize = len(cdata) + 12 + 6 + 8
        hdr = struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<BBHH", 0x42, 0x43, 2, bsize - 1)
        tail = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        self._fh.write(hdr + extra + cdata + tail)

    def close(self):
        while self._pending:
            self._flush_block(min(len(self._pending), self._block_size))
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
