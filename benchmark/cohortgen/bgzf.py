"""BGZF writer: frozen copy of aletsch_tpu_torch/io/bgzf.py's BgzfWriter."""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


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
