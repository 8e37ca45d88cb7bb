"""ctypes wrapper for the native transcript-set (native/core_tset.h).

NativeTSet replaces core/transcript_set.py::TranscriptSet on the default
production path: the per-wave replay (native/core.cpp tset_merge_out), the
per-(chrm,strand) global fold (nts_add) and the output writers
(nts_write_combined / nts_write_individual) all run in C++ without the
GIL — the reference keeps this whole chain native too
(rnacore/transcript_set.cc, gtf/transcript.cc:318-428,
meta/incubator.cc:673-796).  The Python TranscriptSet remains the
byte-exact oracle (ALETSCH_NATIVE_TSET=0 forces it); fallback-assembled
Python per-graph sets are folded in through nts_import_merge so mixed
waves stay byte-identical.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io.bam_native import _load_lib
from ..io.gtf import _FEATURE_GETTER, FEATURE_COLUMNS

_MASK64 = (1 << 64) - 1
_NF = len(FEATURE_COLUMNS)

i64p = ctypes.POINTER(ctypes.c_int64)


def _bind(lib):
    if getattr(lib, "_tset_bound", False):
        return
    vp = ctypes.c_void_p
    vpp = ctypes.POINTER(ctypes.c_void_p)
    cpp = ctypes.POINTER(ctypes.c_char_p)
    lib.nts_new.restype = ctypes.c_void_p
    lib.nts_new.argtypes = [ctypes.c_double]
    lib.nts_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "nts_free_async"):
        lib.nts_free_async.restype = None
        lib.nts_free_async.argtypes = [ctypes.c_void_p]
    lib.nts_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nts_sync.argtypes = [ctypes.c_void_p]
    lib.nts_size.restype = ctypes.c_int64
    lib.nts_size.argtypes = [ctypes.c_void_p]
    lib.core_out_merge_nts.restype = None
    lib.core_out_merge_nts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int32]
    lib.core_group_merge_nts.restype = None
    lib.core_group_merge_nts.argtypes = lib.core_out_merge_nts.argtypes
    lib.core_batch_merge_nts.restype = None
    lib.core_batch_merge_nts.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, vpp, vp, vp, vp,
        ctypes.c_char_p, vp]
    lib.nts_import_merge.restype = None
    lib.nts_import_merge.argtypes = [
        ctypes.c_void_p, ctypes.c_int64] + [vp] * 16 + [ctypes.c_char_p]
    lib.nts_write_combined.restype = ctypes.c_int32
    lib.nts_write_combined.argtypes = [
        vpp, ctypes.c_int32, cpp, ctypes.c_char_p, ctypes.c_char_p]
    lib.nts_write_individual.restype = ctypes.c_int32
    lib.nts_write_individual.argtypes = [
        vpp, ctypes.c_int32, cpp, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_double, ctypes.c_char_p, ctypes.c_int32]
    lib._tset_bound = True


def native_tset_available():
    if os.environ.get("ALETSCH_NATIVE_TSET", "1") == "0":
        return False
    lib = _load_lib()
    if lib is None or not hasattr(lib, "nts_new"):
        return False
    _bind(lib)
    return True


class NativeTSet:
    """A per-(chrm, strand) native transcript set.  API mirrors the
    TranscriptSet surface the incubator/Assembler touch: .chrm, .rid,
    .add(ts, mode)."""

    __slots__ = ("h", "chrm", "rid")

    def __init__(self, chrm, rid, cfg):
        lib = _load_lib()
        _bind(lib)
        self.h = lib.nts_new(float(cfg.min_single_exon_clustering_overlap))
        self.chrm = chrm
        self.rid = rid

    def add(self, ts, mode):
        from ..constants import TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
        assert mode == TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
        # transcript_set.cc:156-160 guards
        if ts.chrm != self.chrm:
            return
        if ts.rid != self.rid and self.rid != -9:
            return
        lib = _load_lib()
        if isinstance(ts, NativeTSet):
            lib.nts_add(self.h, ts.h)
        else:
            _import_merge(lib, self.h, ts)

    def sync(self):
        _load_lib().nts_sync(self.h)

    def size(self):
        return int(_load_lib().nts_size(self.h))

    def __del__(self):
        h, self.h = self.h, None
        if h:
            try:
                lib = _load_lib()
                # deferred free: large set destruction (~77 us each on the
                # production soak) runs on the native drainer thread
                # instead of the main thread (core.cpp nts_free_async)
                if hasattr(lib, "nts_free_async"):
                    lib.nts_free_async(h)
                else:
                    lib.nts_free(h)
            except Exception:       # interpreter shutdown
                pass


def _import_merge(lib, tgt_h, ts):
    """Fold a Python TranscriptSet into a native set (nts_import_merge).
    Used for fallback-assembled per-graph sets (meta/native_core.py
    _replay_transcripts -> NativeTSet.add) and device-path replays; cost
    is proportional to the fallback volume, which is ~0 in production."""
    keys, bcounts = [], []
    icounts, ncopies = [], []
    sid_l, strand_l = [], []
    cov_l, cov2_l, conf_l, abd_l = [], [], [], []
    c1_l, c2_l, nex_l = [], [], []
    exons_l, feats_l, offs = [], [], []
    sbuf = bytearray()

    def push_str(s):
        off = len(sbuf)
        sbuf.extend(s.encode())
        sbuf.append(0)
        return off

    def push_rec(t, sid):
        sid_l.append(sid)
        strand_l.append(ord(t.strand))
        cov_l.append(t.coverage)
        cov2_l.append(t.cov2)
        conf_l.append(t.conf)
        abd_l.append(t.abd)
        c1_l.append(t.count1)
        c2_l.append(t.count2)
        nex_l.append(len(t.exons))
        for a, b in t.exons:
            exons_l.append(int(a))
            exons_l.append(int(b))
        fr = t.feat_row
        if fr is None:
            f = t.features
            fr = [0.0] * _NF if f is None else list(_FEATURE_GETTER(f))
        feats_l.extend(fr)
        offs.append(push_str(t.gene_id))
        offs.append(push_str(t.transcript_id))
        offs.append(push_str(t.meta_tid))

    for h, items in ts.mt.items():
        keys.append((int(h) - 1) & _MASK64)
        bcounts.append(len(items))
        for z in items:
            icounts.append(z.count)
            ncopies.append(len(z.samples))
            push_rec(z.trst, -2)
            for sid, tt in z.samples.items():
                push_rec(tt, int(sid))
    if not keys:
        return
    a_keys = np.asarray(keys, dtype=np.uint64)
    a_bc = np.asarray(bcounts, dtype=np.int32)
    a_ic = np.asarray(icounts, dtype=np.int64)
    a_nc = np.asarray(ncopies, dtype=np.int32)
    a_sid = np.asarray(sid_l, dtype=np.int32)
    a_str = np.asarray(strand_l, dtype=np.int32)
    a_cov = np.asarray(cov_l, dtype=np.float64)
    a_cov2 = np.asarray(cov2_l, dtype=np.float64)
    a_conf = np.asarray(conf_l, dtype=np.float64)
    a_abd = np.asarray(abd_l, dtype=np.float64)
    a_c1 = np.asarray(c1_l, dtype=np.int64)
    a_c2 = np.asarray(c2_l, dtype=np.int32)
    a_nex = np.asarray(nex_l, dtype=np.int32)
    a_ex = np.asarray(exons_l or [0], dtype=np.int64)
    a_ft = np.asarray(feats_l or [0.0], dtype=np.float64)
    a_off = np.asarray(offs, dtype=np.int64)
    lib.nts_import_merge(
        tgt_h, len(keys), a_keys.ctypes.data, a_bc.ctypes.data,
        a_ic.ctypes.data, a_nc.ctypes.data, a_sid.ctypes.data,
        a_str.ctypes.data, a_cov.ctypes.data, a_cov2.ctypes.data,
        a_conf.ctypes.data, a_abd.ctypes.data, a_c1.ctypes.data,
        a_c2.ctypes.data, a_nex.ctypes.data, a_ex.ctypes.data,
        a_ft.ctypes.data, a_off.ctypes.data, bytes(sbuf))


def merge_out_nts(outh, tset, rid, gid, instance, chrm, skip_se):
    """Replay one core_resolve_group CoreOut into a native set."""
    _load_lib().core_out_merge_nts(
        outh, tset.h, int(rid), int(gid), int(instance), chrm.encode(),
        1 if skip_se else 0)


def merge_group_nts(gh, tset, rid, gid, instance, chrm, skip_se):
    """Replay a completed GroupRun's transcripts into a native set."""
    _load_lib().core_group_merge_nts(
        gh, tset.h, int(rid), int(gid), int(instance), chrm.encode(),
        1 if skip_se else 0)


def merge_batch_nts(bh, asms, chrm):
    """Replay a whole BatchOut wave into the groups' native target sets
    in group order (byte-identical to the Python _replay_batch)."""
    lib = _load_lib()
    n = len(asms)
    hs = (ctypes.c_void_p * n)(*[a.tmerge.h for a in asms])
    rid = np.asarray([a.rid for a in asms], dtype=np.int64)
    gid = np.asarray([a.gid for a in asms], dtype=np.int64)
    inst = np.asarray([a.instance for a in asms], dtype=np.int64)
    skip = np.asarray([1 if a.cfg.skip_single_exon_transcripts else 0
                       for a in asms], dtype=np.int32)
    lib.core_batch_merge_nts(bh, n, hs, rid.ctypes.data, gid.ctypes.data,
                             inst.ctypes.data, chrm.encode(),
                             skip.ctypes.data)


def write_combined(sets, path, source):
    """sets: [(chrm, NativeTSet)] in the caller's sorted order."""
    lib = _load_lib()
    n = len(sets)
    hs = (ctypes.c_void_p * max(n, 1))(*[s.h for _, s in sets])
    chrms = (ctypes.c_char_p * max(n, 1))(*[c.encode() for c, _ in sets])
    rc = lib.nts_write_combined(hs, n, chrms, path.encode(),
                                source.encode())
    if rc != 0:
        raise OSError("nts_write_combined failed for %s" % path)


def write_individual(sets, out_dir, n_samples, min_se, source, nthreads):
    lib = _load_lib()
    n = len(sets)
    hs = (ctypes.c_void_p * max(n, 1))(*[s.h for _, s in sets])
    chrms = (ctypes.c_char_p * max(n, 1))(*[c.encode() for c, _ in sets])
    rc = lib.nts_write_individual(hs, n, chrms, out_dir.encode(),
                                  int(n_samples), float(min_se),
                                  source.encode(), int(nthreads))
    if rc != 0:
        raise OSError("nts_write_individual failed in %s" % out_dir)
