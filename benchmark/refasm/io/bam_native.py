"""ctypes binding for the native BAM batch decoder (native/abam.cpp).

Exposes the same reader interface as io.bam.BamReader but decodes records in
batches through the C++ library: fixed int32 fields, cigar words, qnames and
preparsed coordinate pools (match intervals, interior splices, indel
intervals) arrive as flat arrays, so the per-record Python work is object
assembly only; cigar tuples decode lazily.  Falls back transparently to the
pure-Python reader when the shared library is unavailable.  Builds its
own libabam.so from native/ on first use (_build_lib): under a lock, in a
private copy of the sources, renamed into place under build/, so that no
process ever loads a partly written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from .bam import BamHeader, BamRec

# the reference's own copy of the C++ core (refasm/native/), built into
# build/benchmark_refasm/ at the root of the checkout
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _NATIVE_DIR))), "build", "benchmark_refasm")

_LIB = None
_LIB_TRIED = False
_LIB_LOCK = threading.Lock()     # a second thread waits for the first load

BATCH = 4096
FIXED_W = 24
CIG_CAP = BATCH * 16
Q_CAP = BATCH * 64
COORD_CAP = BATCH * 40


def _build_lib(native_dir=None, build_dir=None):
    """Path of a whole libabam.so built from native_dir's sources (default
    refasm/native/) into build_dir (default build/benchmark_refasm/), named by a
    hash of the sources.  The first process to need it builds it under an
    exclusive lock, in a private copy of the sources, and renames it into
    place: a file at that path is always complete, and concurrent processes
    wait for the one build.  Raises when make fails."""
    native_dir = _NATIVE_DIR if native_dir is None else native_dir
    build_dir = _BUILD_DIR if build_dir is None else build_dir
    h = hashlib.sha256()
    for name in sorted(os.listdir(native_dir)):
        path = os.path.join(native_dir, name)
        if os.path.isfile(path) and not name.endswith(".so"):
            with open(path, "rb") as fh:
                h.update(name.encode() + b"\0" + fh.read())
    out = os.path.join(build_dir, "libabam_%s.so" % h.hexdigest()[:16])
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(out + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if not os.path.exists(out):
            with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                src = os.path.join(tmp, "native")
                shutil.copytree(native_dir, src,
                                ignore=shutil.ignore_patterns("*.so"))
                subprocess.run(["make", "-s", "-C", src], check=True,
                               capture_output=True)
                os.replace(os.path.join(src, "libabam.so"), out)
    return out


def _load_lib():
    with _LIB_LOCK:
        return _open_lib()


def _open_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(_build_lib())
        lib.abam_open.restype = ctypes.c_void_p
        lib.abam_open.argtypes = [ctypes.c_char_p]
        lib.abam_close.argtypes = [ctypes.c_void_p]
        lib.abam_ntargets.argtypes = [ctypes.c_void_p]
        lib.abam_ntargets.restype = ctypes.c_int
        lib.abam_target_name.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_char_p, ctypes.c_int]
        lib.abam_target_name.restype = ctypes.c_int
        lib.abam_target_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.abam_target_len.restype = ctypes.c_int64
        lib.abam_tell.argtypes = [ctypes.c_void_p]
        lib.abam_tell.restype = ctypes.c_uint64
        lib.abam_seek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.abam_seek.restype = ctypes.c_int
        lib.abam_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.abam_read_batch.restype = ctypes.c_int
        lib.abam_scan_open.restype = ctypes.c_void_p
        lib.abam_scan_open.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 10
        if hasattr(lib, "abam_scan_set_quirks"):
            lib.abam_scan_set_quirks.restype = None
            lib.abam_scan_set_quirks.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int32]
        lib.abam_scan_free.argtypes = [ctypes.c_void_p]
        lib.abam_scan_drop.argtypes = [ctypes.c_void_p]
        lib.abam_scan_nbundles.argtypes = [ctypes.c_void_p]
        lib.abam_scan_nbundles.restype = ctypes.c_int
        lib.abam_scan_next.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.abam_scan_next.restype = ctypes.c_int
        if hasattr(lib, "abam_scan_enable_boundaries"):
            lib.abam_scan_enable_boundaries.argtypes = [ctypes.c_void_p,
                                                        ctypes.c_int64]
            lib.abam_scan_drain_boundaries.argtypes = [ctypes.c_void_p]
            lib.abam_scan_drain_boundaries.restype = ctypes.c_int
            lib.abam_scan_boundary_fill.argtypes = [
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_int64)]
        lib.abam_scan_chunk_sizes.argtypes = [ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_int64)]
        lib.abam_scan_chunk_fill.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.abam_cluster_pereads.restype = ctypes.c_void_p
        lib.abam_cluster_pereads.argtypes = [
            ctypes.c_int32, i32p, i32p, u8p,
            ctypes.c_int32, i32p, i32p,
            ctypes.c_int32, i32p, i32p,
            i32p, i32p,
            i32p, i32p, i32p,
            ctypes.c_int32, i32p, i32p, i32p,
            ctypes.c_int32]
        lib.abam_cluster_sizes.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.abam_cluster_fill.argtypes = [ctypes.c_void_p, i32p, i32p,
                                          i32p, u8p]
        lib.abam_cluster_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def native_available():
    return _load_lib() is not None


class _Batch:
    __slots__ = ("fixed", "voffs", "cigars", "qnames", "coords", "count",
                 "rows")


class NativeBamReader:
    """Batch-decoding BAM reader with the BamReader interface."""

    def __init__(self, path):
        lib = _load_lib()
        if lib is None:
            raise OSError("native BAM library unavailable")
        self._lib = lib
        self._h = lib.abam_open(path.encode())
        if not self._h:
            raise IOError("cannot open BAM %s" % path)
        nt = lib.abam_ntargets(self._h)
        names = []
        lengths = []
        buf = ctypes.create_string_buffer(1024)
        for i in range(nt):
            lib.abam_target_name(self._h, i, buf, 1024)
            names.append(buf.value.decode())
            lengths.append(int(lib.abam_target_len(self._h, i)))
        self.header = BamHeader("", names, lengths)
        self._fixed = np.zeros((BATCH, FIXED_W), dtype=np.int32)
        self._voffs = np.zeros(BATCH, dtype=np.uint64)
        self._cigars = np.zeros(CIG_CAP, dtype=np.uint32)
        self._qnames = ctypes.create_string_buffer(Q_CAP)
        self._coords = np.zeros(COORD_CAP, dtype=np.int32)
        self._batch = None
        self._cursor = 0

    def close(self):
        if self._h:
            self._lib.abam_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def read_batch_arrays(self):
        """Decode the next batch; returns a _Batch of owned arrays or None.

        fixed: [n, 24] int32; voffs: [n] uint64; cigars/coords: pools;
        qnames: bytes pool (NUL-terminated names at fixed[:,10]).
        """
        lib = self._lib
        n = lib.abam_read_batch(
            self._h, BATCH,
            self._fixed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._voffs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            self._cigars.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            CIG_CAP, self._qnames, Q_CAP,
            self._coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            COORD_CAP)
        if n <= 0:
            return None
        b = _Batch()
        b.count = n
        b.fixed = self._fixed[:n].copy()
        b.rows = None
        b.voffs = self._voffs[:n].copy()
        last = b.fixed[n - 1]
        b.cigars = self._cigars[:int(last[9]) + int(last[8])].copy()
        b.coords = self._coords[:int(last[17]) + 2 * int(last[18])
                                + int(last[19]) + 2 * int(last[20])].copy()
        qend = int(last[10]) + int(last[11]) + 1
        b.qnames = self._qnames.raw[:qend]
        return b

    def scan_region(self, tid, end1, voff, params, chunk_records=262144,
                    need_qnames=True):
        """Native record->bundle scan of one region (generator loop); yields
        lists of ScanBundle.  The caller must not use the reader until the
        generator is exhausted or closed."""
        self.seek(voff)
        sc = _apply_scan_quirks(self._lib, self._lib.abam_scan_open(
            self._h, 0, tid, end1, params.min_mapq, params.max_num_cigar,
            params.max_read_span, params.min_bundle_gap, params.use_second,
            params.uniq_only, params.library_type))
        return _scan_chunks(self._lib, sc, chunk_records, need_qnames)

    def scan_region_raw(self, tid, end1, voff, params, chunk_records=262144):
        """Region scan yielding raw chunk pools — (nb, mlist, fixed,
        coords, mev, iev, frgs, splices, base_ptrs) — with no ScanBundle
        objects; feed for the generator's fused light-bundle consumer
        (meta/generator.py _resolve_scan_fused).  mlist is the [nb, 14]
        bundle metadata as Python ints; base_ptrs are the five pool
        addresses (fixed, coords, mev, iev, frgs)."""
        self.seek(voff)
        lib = self._lib
        sc = _apply_scan_quirks(lib, lib.abam_scan_open(
            self._h, 0, tid, end1, params.min_mapq, params.max_num_cigar,
            params.max_read_span, params.min_bundle_gap, params.use_second,
            params.uniq_only, params.library_type))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        try:
            while True:
                more = lib.abam_scan_next(sc, chunk_records)
                nb = lib.abam_scan_nbundles(sc)
                if nb:
                    sizes = (ctypes.c_int64 * 7)()
                    lib.abam_scan_chunk_sizes(sc, sizes)
                    rows, _qn, co, me, ie, fr, sp = (int(x) for x in sizes)
                    meta = np.empty(nb * 14, dtype=np.int64)
                    fixed = np.empty((max(rows, 1), 25), dtype=np.int32)
                    coords = np.empty(max(co, 1), dtype=np.int32)
                    mev = np.empty(max(me, 1), dtype=np.int32)
                    iev = np.empty(max(ie, 1), dtype=np.int32)
                    frgs = np.empty(max(fr, 1), dtype=np.int32)
                    splices = np.empty(max(sp, 1), dtype=np.int32)
                    lib.abam_scan_chunk_fill(
                        sc, meta.ctypes.data_as(i64p),
                        fixed.ctypes.data_as(i32p), None,
                        coords.ctypes.data_as(i32p),
                        mev.ctypes.data_as(i32p), iev.ctypes.data_as(i32p),
                        frgs.ctypes.data_as(i32p),
                        splices.ctypes.data_as(i32p))
                    lib.abam_scan_drop(sc)
                    yield (nb, meta.reshape(nb, 14).tolist(), fixed,
                           coords, mev, iev, frgs, splices,
                           (fixed.ctypes.data, coords.ctypes.data,
                            mev.ctypes.data, iev.ctypes.data,
                            frgs.ctypes.data))
                else:
                    lib.abam_scan_drop(sc)
                if more == 0:
                    break
        finally:
            lib.abam_scan_free(sc)

    def scan_preview(self, params, chunk_records=262144, need_qnames=True):
        """Native whole-file preview scan (previewer insert-size loop)."""
        sc = _apply_scan_quirks(self._lib, self._lib.abam_scan_open(
            self._h, 1, -1, 0, params.min_mapq, params.max_num_cigar,
            params.max_read_span, params.min_bundle_gap, params.use_second,
            params.uniq_only, params.library_type))
        return _scan_chunks(self._lib, sc, chunk_records, need_qnames)

    def scan_preview_pools(self, params, chunk_records=262144,
                           boundary_sink=None):
        """Preview scan yielding raw chunk pools — (meta[nb,14] int64,
        fixed[rows,25], coords, mev, iev, frgs) — with no ScanBundle
        objects and no qname marshalling; feed for core_preview_chunk.

        boundary_sink=(region_len, sample_profile): piggyback the region
        grid on this decode pass (native boundary tracker, the serial
        set_batch_boundaries semantics).  When the consumer closes the
        generator early (insert-size cap), the remaining records drain
        through a boundary-only native loop and the profile's region
        tables are filled before the scanner is freed — one full-file
        decode serves both the preview and set_batch_boundaries."""
        lib = self._lib
        sc = _apply_scan_quirks(lib, lib.abam_scan_open(
            self._h, 1, -1, 0, params.min_mapq, params.max_num_cigar,
            params.max_read_span, params.min_bundle_gap, params.use_second,
            params.uniq_only, params.library_type))
        if boundary_sink is not None:
            region_len, bsp = boundary_sink
            lib.abam_scan_enable_boundaries(sc, region_len)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        try:
            while True:
                more = lib.abam_scan_next(sc, chunk_records)
                nb = lib.abam_scan_nbundles(sc)
                if nb:
                    sizes = (ctypes.c_int64 * 7)()
                    lib.abam_scan_chunk_sizes(sc, sizes)
                    rows, _qn, co, me, ie, fr, sp = (int(x) for x in sizes)
                    meta = np.empty(nb * 14, dtype=np.int64)
                    fixed = np.empty((max(rows, 1), 25), dtype=np.int32)
                    coords = np.empty(max(co, 1), dtype=np.int32)
                    mev = np.empty(max(me, 1), dtype=np.int32)
                    iev = np.empty(max(ie, 1), dtype=np.int32)
                    frgs = np.empty(max(fr, 1), dtype=np.int32)
                    splices = np.empty(max(sp, 1), dtype=np.int32)
                    lib.abam_scan_chunk_fill(
                        sc, meta.ctypes.data_as(i64p),
                        fixed.ctypes.data_as(i32p), None,
                        coords.ctypes.data_as(i32p), mev.ctypes.data_as(i32p),
                        iev.ctypes.data_as(i32p), frgs.ctypes.data_as(i32p),
                        splices.ctypes.data_as(i32p))
                    lib.abam_scan_drop(sc)
                    yield meta.reshape(nb, 14), fixed, coords, mev, iev, frgs
                else:
                    lib.abam_scan_drop(sc)
                if more == 0:
                    break
        finally:
            if boundary_sink is not None:
                lib.abam_scan_drain_boundaries(sc)
                self._fill_boundaries(lib, sc, bsp)
            lib.abam_scan_free(sc)

    @staticmethod
    def _fill_boundaries(lib, sc, sp):
        """Copy the scanner's boundary tables into the sample profile
        (start2/end2 mirror start1/end1 like the Python passes)."""
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        for tid in range(len(sp.start1)):
            n = len(sp.start1[tid])
            s1 = np.zeros(n, dtype=np.int64)
            s2 = np.zeros(n, dtype=np.int64)
            so = np.zeros(n, dtype=np.uint64)
            e1 = np.zeros(n, dtype=np.int64)
            lib.abam_scan_boundary_fill(
                sc, tid, s1.ctypes.data_as(i64p), s2.ctypes.data_as(i64p),
                so.ctypes.data_as(u64p), e1.ctypes.data_as(i64p))
            sp.start1[tid] = s1.tolist()
            sp.start2[tid] = s2.tolist()
            sp.start_off[tid] = so.tolist()
            sp.end1[tid] = e1.tolist()
            sp.end2[tid] = list(sp.end1[tid])

    def tell(self):
        if self._batch is not None and self._cursor < self._batch.count:
            return int(self._batch.voffs[self._cursor])
        return int(self._lib.abam_tell(self._h))

    def seek(self, voff):
        self._batch = None
        self._cursor = 0
        self._lib.abam_seek(self._h, voff)

    def read_rec(self):
        if self._batch is None or self._cursor >= self._batch.count:
            self._batch = self.read_batch_arrays()
            self._cursor = 0
            if self._batch is None:
                return None
        b = self._batch
        if b.rows is None:
            b.rows = b.fixed.tolist()
        f = b.rows[self._cursor]
        rec = BamRec()
        rec.tid = f[0]
        rec.pos = f[1]
        rec.rpos = f[2]
        rec.mapq = f[3]
        rec.qual = f[3]
        rec.flag = f[4]
        rec.mtid = f[5]
        rec.mpos = f[6]
        rec.isize = f[7]
        rec.set_lazy_cigar(b.cigars, f[9], f[8], f[21])
        qoff = f[10]
        rec.qname = b.qnames[qoff:qoff + f[11]].decode()
        rec.xs = chr(f[12])
        rec.hi = f[13]
        rec.nh = f[14]
        rec.nm = f[15]
        rec.l_seq = 0
        coff = f[17]
        cend = coff + 2 * f[18] + f[19] + 2 * f[20]
        rec.coords = b.coords[coff:cend].tolist()
        rec.mcnt = f[18]
        rec.scnt = f[19]
        rec.icnt = f[20]
        self._cursor += 1
        return rec


class ScanBundle:
    """One flushed bundle from the native scanner: fixed rows are 25 int32
    (24 decoder fields + routed strand in slot 22 + hid in slot 24).
    splices is the sorted-unique splice-position list (computed at flush)."""
    __slots__ = ("strand", "tid", "lpos", "rpos", "epoch", "fixed",
                 "qnames", "coords", "mev", "iev", "frgs", "splices",
                 "xsp", "xsm", "ptrs", "cnts")


def _scan_chunks(lib, sc, chunk_records, need_qnames=True):
    """Yield lists of ScanBundle per processed chunk until the scan ends.

    All bundles of a chunk marshal through ONE sizes + ONE fill call into
    pooled buffers; each ScanBundle holds zero-copy views into the pools.
    need_qnames=False skips the qname pool entirely (light bundles and the
    native previewer never read names)."""
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    try:
        while True:
            more = lib.abam_scan_next(sc, chunk_records)
            nb = lib.abam_scan_nbundles(sc)
            out = []
            if nb:
                sizes = (ctypes.c_int64 * 7)()
                lib.abam_scan_chunk_sizes(sc, sizes)
                rows, qn_total, co, me, ie, fr, sp = (int(x) for x in sizes)
                meta = np.empty(nb * 14, dtype=np.int64)
                fixed = np.empty((max(rows, 1), 25), dtype=np.int32)
                qbuf = (ctypes.create_string_buffer(max(qn_total, 1))
                        if need_qnames else None)
                coords = np.empty(max(co, 1), dtype=np.int32)
                mev = np.empty(max(me, 1), dtype=np.int32)
                iev = np.empty(max(ie, 1), dtype=np.int32)
                frgs = np.empty(max(fr, 1), dtype=np.int32)
                splices = np.empty(max(sp, 1), dtype=np.int32)
                lib.abam_scan_chunk_fill(
                    sc, meta.ctypes.data_as(i64p),
                    fixed.ctypes.data_as(i32p), qbuf,
                    coords.ctypes.data_as(i32p), mev.ctypes.data_as(i32p),
                    iev.ctypes.data_as(i32p), frgs.ctypes.data_as(i32p),
                    splices.ctypes.data_as(i32p))
                qraw = qbuf.raw[:qn_total] if need_qnames else b""
                # one C-level conversion per chunk: per-element numpy
                # scalar reads (14 per bundle) dominated this loop
                mlist = meta.reshape(nb, 14).tolist()
                # raw pool addresses: the native-core marshal passes each
                # bundle's arrays by pointer; precomputing them here (on
                # the scan worker thread) keeps per-bundle .ctypes.data
                # lookups off the main thread (meta/native_core.py
                # _marshal_batch fast path).  The views below keep the
                # pools alive for as long as any bundle does.
                p_fix = fixed.ctypes.data
                p_co = coords.ctypes.data
                p_me = mev.ctypes.data
                p_ie = iev.ctypes.data
                p_fr = frgs.ctypes.data
                ro = qo = co2 = mo = io = fo = so = 0
                for b in range(nb):
                    (ms, mtid, mlpos, mrpos, n, ql, cl, ml, il,
                     mepoch, fl, sl, xsp, xsm) = mlist[b]
                    sb = ScanBundle()
                    sb.strand = "+" if ms == 0 else "-"
                    sb.tid = mtid
                    sb.lpos = mlpos
                    sb.rpos = mrpos
                    sb.epoch = mepoch
                    sb.xsp = xsp
                    sb.xsm = xsm
                    sb.fixed = fixed[ro:ro + n]
                    sb.qnames = qraw[qo:qo + ql] if need_qnames else b""
                    sb.coords = coords[co2:co2 + cl]
                    sb.mev = mev[mo:mo + ml]
                    sb.iev = iev[io:io + il]
                    sb.frgs = frgs[fo:fo + fl]
                    sb.splices = splices[so:so + sl]
                    sb.ptrs = (p_fix + 100 * ro, p_co + 4 * co2,
                               p_me + 4 * mo, p_ie + 4 * io, p_fr + 4 * fo)
                    sb.cnts = (n, ml // 2, il // 2, fl // 2)
                    ro += n; qo += ql; co2 += cl; mo += ml
                    io += il; fo += fl; so += sl
                    out.append(sb)
            lib.abam_scan_drop(sc)
            if out:
                yield out
            if more == 0:
                break
    finally:
        lib.abam_scan_free(sc)


def _apply_scan_quirks(lib, sc):
    """ALETSCH_REF_QUIRKS: the reference applies its mate-span filter to
    ANY read with 0x8 unset (generator.cc:95), silently dropping
    single-end/long reads past max_read_span; byte-parity runs replicate
    that in the native scanner (abam_scan_set_quirks)."""
    import os
    if sc and os.environ.get("ALETSCH_REF_QUIRKS") == "1" and \
            hasattr(lib, "abam_scan_set_quirks"):
        lib.abam_scan_set_quirks(sc, 1)
    return sc


class _ScanParams:
    """Filter bundle passed to scan_region/scan_preview."""
    __slots__ = ("min_mapq", "max_num_cigar", "max_read_span",
                 "min_bundle_gap", "use_second", "uniq_only", "library_type")


def scan_params(cfg, library_type):
    p = _ScanParams()
    p.min_mapq = cfg.min_mapping_quality
    p.max_num_cigar = cfg.max_num_cigar
    p.max_read_span = cfg.max_read_span
    p.min_bundle_gap = cfg.min_bundle_gap
    p.use_second = 1 if cfg.use_second_alignment else 0
    p.uniq_only = 1 if cfg.uniquely_mapped_only else 0
    p.library_type = library_type
    return p


def cluster_pereads_native(vstarts, vends, adj_next, rkeys, rvals,
                           lkeys, lvals, hpos, hrpos, chain_off, chain_len,
                           chain_pool, cand_frag, cand_h1, cand_h2, max_gap):
    """Native build_pereads_clusters core; returns (meta[n,10], moff,
    members, aligned) or None when the library is unavailable."""
    lib = _load_lib()
    if lib is None or not hasattr(lib, "abam_cluster_pereads"):
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def ip(a):
        return a.ctypes.data_as(i32p)

    h = lib.abam_cluster_pereads(
        len(vstarts), ip(vstarts), ip(vends),
        adj_next.ctypes.data_as(u8p),
        len(rkeys), ip(rkeys), ip(rvals),
        len(lkeys), ip(lkeys), ip(lvals),
        ip(hpos), ip(hrpos),
        ip(chain_off), ip(chain_len), ip(chain_pool),
        len(cand_frag), ip(cand_frag), ip(cand_h1), ip(cand_h2),
        max_gap)
    sizes = (ctypes.c_int64 * 3)()
    lib.abam_cluster_sizes(h, sizes)
    nc, nm, na = int(sizes[0]), int(sizes[1]), int(sizes[2])
    meta = np.zeros(max(nc * 10, 1), dtype=np.int32)
    moff = np.zeros(max(nc, 1), dtype=np.int32)
    members = np.zeros(max(nm, 1), dtype=np.int32)
    aligned = np.zeros(max(na, 1), dtype=np.uint8)
    lib.abam_cluster_fill(h, ip(meta), ip(moff),
                          ip(members), aligned.ctypes.data_as(u8p))
    lib.abam_cluster_free(h)
    return (meta[:nc * 10].reshape(nc, 10), moff[:nc],
            members[:nm], aligned[:na])


def open_bam(path):
    """Best reader available: native if the library builds, else Python."""
    if native_available():
        return NativeBamReader(path)
    from .bam import BamReader
    return BamReader(path)


_tls = None
_reader_gen = [0]


def invalidate_cached_readers():
    """Force the next open_bam_cached per path to re-stat (called when a
    BAM may have been rewritten in-process: sim.write_bam, Incubator
    startup).  Within one generation the per-(sample, region) opens skip
    the os.stat entirely (~6k stats per production run)."""
    _reader_gen[0] += 1


def open_bam_cached(path):
    """Thread-cached NativeBamReader for repeated region scans of the same
    file (the generator seeks per region anyway).  Keyed by (path, mtime,
    size) so a rewritten file gets a fresh reader; capped per thread with
    LRU eviction.  Returns None when the native library is unavailable —
    callers fall back to open_bam and manage the lifetime themselves."""
    global _tls
    if not native_available():
        return None
    import threading
    if _tls is None:
        _tls = threading.local()
    cache = getattr(_tls, "readers", None)
    if cache is None:
        cache = {}
        _tls.readers = cache
    gen = _reader_gen[0]
    seen = getattr(_tls, "stat_gen", None)
    if seen is None:
        seen = {}
        _tls.stat_gen = seen
    if seen.get(path) == gen:
        for k, r in cache.items():
            if k[0] == path:
                del cache[k]
                cache[k] = r        # refresh LRU position
                return r
    st = os.stat(path)
    seen[path] = gen
    key = (path, st.st_mtime_ns, st.st_size)
    r = cache.pop(key, None)
    if r is None:
        # drop stale entries for the same path (rewritten file)
        for k in [k for k in cache if k[0] == path]:
            cache.pop(k).close()
        r = NativeBamReader(path)
        if len(cache) >= 64:
            cache.pop(next(iter(cache))).close()   # oldest (insertion order)
    cache[key] = r
    return r
