"""ctypes binding for the native group assembler (native/core.cpp).

One call per Assembler.resolve group (or per immediate splice-free bundle):
the scanner's flushed bundle arrays go in, assembled transcripts plus their
RF features come out.  The Python Assembler remains the semantic oracle —
the native core is bit-exact against it (differential-fuzz enforced) and is
skipped whenever a bundle did not come straight from the native scanner or
verbose diagnostics are requested.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..io.bam_native import _load_lib
from ..io.gtf import FEATURE_COLUMNS, Transcript, gtf_source

CFG_NI = 9
CFG_ND = 14

i32p = ctypes.POINTER(ctypes.c_int32)
i64p = ctypes.POINTER(ctypes.c_int64)
f64p = ctypes.POINTER(ctypes.c_double)

_preview_tls = None


def _preview_buf():
    """Per-thread reusable 1000-slot distance buffer for the previewer."""
    global _preview_tls
    if _preview_tls is None:
        import threading
        _preview_tls = threading.local()
    b = getattr(_preview_tls, "buf", None)
    if b is None:
        b = np.empty(1000, dtype=np.int64)
        _preview_tls.buf = b
    return b


def _bind(lib):
    # bind per CDLL instance: the library can be re-loaded (tests/fuzz swap
    # the loader state), and an unbound instance would truncate the returned
    # pointer to c_int
    if getattr(lib, "_core_bound", False):
        return
    # array parameters are declared c_void_p: callers pass arr.ctypes.data
    # (a plain int), which skips the per-call POINTER cast overhead
    vp = ctypes.c_void_p
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.core_resolve_group.restype = ctypes.c_void_p
    lib.core_resolve_group.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        vp,
        vpp, vpp,
        vpp, vp,
        vpp, vp,
        vpp, vp,
        vp, vp, vp, vp, vp, vp,
        vp, vp]
    lib.core_out_sizes.argtypes = [ctypes.c_void_p, i64p]
    lib.core_out_fill.argtypes = [ctypes.c_void_p] + [vp] * 12
    lib.core_out_free.argtypes = [ctypes.c_void_p]
    lib.core_preview_bundle.restype = ctypes.c_int64
    lib.core_preview_bundle.argtypes = [
        ctypes.c_int32, vp, vp,
        vp, ctypes.c_int64, vp, ctypes.c_int64,
        vp, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        vp, vp, vp, vp]
    if hasattr(lib, "core_preview_chunk"):
        lib.core_preview_chunk.restype = ctypes.c_int64
        lib.core_preview_chunk.argtypes = [
            ctypes.c_int32, vp, vp, vp, vp, vp, vp,
            ctypes.c_int64, vp, vp, vp, vp, vp]
    lib.core_cluster_groups.restype = ctypes.c_int64
    lib.core_cluster_groups.argtypes = [
        ctypes.c_int32, vpp, vp,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, vp]
    # device-paused group assembly (wave-batched greedy DP; core.cpp
    # GroupRun + ops/greedy_dp.py)
    if hasattr(lib, "core_group_start"):
        lib.core_group_start.restype = ctypes.c_void_p
        lib.core_group_start.argtypes = \
            lib.core_resolve_group.argtypes + [ctypes.c_int32] * 3
        lib.core_group_advance.restype = ctypes.c_int32
        lib.core_group_advance.argtypes = [ctypes.c_void_p]
        lib.core_greedy_export.restype = ctypes.c_int32
        lib.core_greedy_export.argtypes = [ctypes.c_void_p, vp,
                                           ctypes.c_int32]
        lib.core_greedy_step.restype = ctypes.c_int32
        lib.core_greedy_step.argtypes = [ctypes.c_void_p, vp]
        lib.core_greedy_solve_host.restype = ctypes.c_int32
        lib.core_greedy_solve_host.argtypes = [ctypes.c_void_p]
        lib.core_group_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.core_group_fill.argtypes = [ctypes.c_void_p] + [vp] * 12
        lib.core_group_free.argtypes = [ctypes.c_void_p]
    # fused greedy drain (one dispatch per wave round; ops/greedy_fused.py)
    if hasattr(lib, "core_greedy_export_fused"):
        lib.core_greedy_export_fused.restype = ctypes.c_int32
        lib.core_greedy_export_fused.argtypes = [
            ctypes.c_void_p, vp, vp, ctypes.c_int32, vp, vp]
        lib.core_greedy_consume_fused.restype = ctypes.c_int32
        lib.core_greedy_consume_fused.argtypes = [
            ctypes.c_void_p, vp, vp, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, vp]
    # device-paused bridging DP (wave-batched top-K stack DP;
    # ops/bridge_topk.py)
    if hasattr(lib, "core_bridge_export"):
        lib.core_bridge_export.restype = ctypes.c_int32
        lib.core_bridge_export.argtypes = \
            [ctypes.c_void_p] + [vp] * 4 + [ctypes.c_int32] * 5
        lib.core_bridge_step.restype = ctypes.c_int32
        lib.core_bridge_step.argtypes = \
            [ctypes.c_void_p] + [vp] * 3 + [ctypes.c_int32] * 4
        lib.core_bridge_solve_host.restype = ctypes.c_int32
        lib.core_bridge_solve_host.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "core_bridge_pending"):
        lib.core_bridge_pending.restype = ctypes.c_int64
        lib.core_bridge_pending.argtypes = [ctypes.c_void_p]
        lib.core_bridge_export_at.restype = ctypes.c_int32
        lib.core_bridge_export_at.argtypes = \
            [ctypes.c_void_p, ctypes.c_int64] + [vp] * 4 + \
            [ctypes.c_int32] * 5
    # multithreaded batch group assembly (core_resolve_groups_mt)
    if hasattr(lib, "core_resolve_groups_mt"):
        lib.core_resolve_groups_mt.restype = ctypes.c_void_p
        lib.core_resolve_groups_mt.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            vp,
            vp,
            vpp, vpp,
            vpp, vp,
            vpp, vp,
            vpp, vp,
            vp, vp, vp, vp, vp, vp,
            vp, vp]
        lib.core_batch_sizes.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         i64p]
        lib.core_batch_fill.argtypes = [ctypes.c_void_p,
                                        ctypes.c_int32] + [vp] * 12
        lib.core_batch_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "core_batch_fill_all"):
        lib.core_batch_sizes_all.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int32, vp]
        lib.core_batch_fill_all.argtypes = [ctypes.c_void_p,
                                            ctypes.c_int32] + [vp] * 12
    if hasattr(lib, "core_batch_hashes"):
        lib.core_batch_hashes.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int32, vp]
    if hasattr(lib, "core_batch_capture"):
        lib.core_batch_capture.restype = None
        lib.core_batch_capture.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            vp, vp,
            vpp, vpp,
            vpp, vp,
            vpp, vp,
            vpp, vp,
            vp, vp, vp, vp, vp, vp,
            vp, vp, ctypes.c_char_p]
    # async form: launch returns a job handle at once (the C++ job copies
    # every small index array; only the scanner payloads must stay alive),
    # join blocks until the pool drains and returns the BatchOut handle
    if hasattr(lib, "core_resolve_groups_mt_async"):
        lib.core_resolve_groups_mt_async.restype = ctypes.c_void_p
        lib.core_resolve_groups_mt_async.argtypes = \
            lib.core_resolve_groups_mt.argtypes
        lib.core_batch_join.restype = ctypes.c_void_p
        lib.core_batch_join.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "core_resolve_groups_mt_async_merge"):
        lib.core_resolve_groups_mt_async_merge.restype = ctypes.c_void_p
        lib.core_resolve_groups_mt_async_merge.argtypes = \
            lib.core_resolve_groups_mt.argtypes + \
            [vpp, vp, vp, vp, ctypes.c_char_p, vp]
    # device-paused scallop ladder (pause kind 4; ops/ladder_kernel.py)
    if hasattr(lib, "core_ladder_export"):
        lib.core_group_set_ladder.restype = None
        lib.core_group_set_ladder.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int32]
        lib.core_ladder_export.restype = ctypes.c_int32
        lib.core_ladder_export.argtypes = \
            [ctypes.c_void_p] + [vp] * 12 + [ctypes.c_int32] * 5
        lib.core_ladder_consume.restype = ctypes.c_int32
        lib.core_ladder_consume.argtypes = \
            [ctypes.c_void_p, vp, vp, ctypes.c_int32, ctypes.c_int32,
             ctypes.c_int32, vp]
        lib.core_ladder_solve_host.restype = ctypes.c_int32
        lib.core_ladder_solve_host.argtypes = [ctypes.c_void_p]
    # resolution-ladder rung-fire histogram (round-4 verdict weak#4)
    if hasattr(lib, "core_ladder_hist"):
        lib.core_ladder_hist.restype = None
        lib.core_ladder_hist.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    # standalone native drain benchmark (crossover model calibration)
    if hasattr(lib, "core_bench_drain"):
        lib.core_bench_drain.restype = None
        lib.core_bench_drain.argtypes = \
            [vp] * 4 + [ctypes.c_int32] * 3 + [vp] * 3
    # standalone native ladder benchmark (ladder crossover measurement)
    if hasattr(lib, "core_bench_ladder"):
        lib.core_bench_ladder.restype = None
        lib.core_bench_ladder.argtypes = \
            [ctypes.c_int32] + [vp] * 10 + [vp] * 2 + [vp] * 2
    # device-paused cross-sample support reduce (ops/support.py)
    if hasattr(lib, "core_support_export"):
        lib.core_support_export.restype = ctypes.c_int32
        lib.core_support_export.argtypes = [ctypes.c_void_p, vp,
                                            ctypes.c_int32, ctypes.c_int32]
        lib.core_support_step.restype = ctypes.c_int32
        lib.core_support_step.argtypes = [ctypes.c_void_p, vp]
        lib.core_support_solve_host.restype = ctypes.c_int32
        lib.core_support_solve_host.argtypes = [ctypes.c_void_p]
    lib._core_bound = True


def native_core_available():
    if os.environ.get("ALETSCH_NATIVE_CORE", "1") == "0":
        return False
    lib = _load_lib()
    if lib is None or not hasattr(lib, "core_resolve_group"):
        return False
    _bind(lib)
    return True


def _cfg_arrays(cfg):
    # validated per-cfg cache: the value token is compared on every call, so
    # a mutated cfg (tests tweak flags between runs) rebuilds the arrays
    tok = (cfg.min_junction_support, cfg.min_subregion_gap,
           cfg.min_subregion_length, cfg.max_reads_partition_gap,
           cfg.bridge_dp_solution_size, cfg.bridge_dp_stack_size,
           cfg.bridge_end_relaxing, cfg.max_group_boundary_distance,
           cfg.max_num_exons,
           cfg.min_guaranteed_edge_weight, cfg.min_subregion_overlap,
           cfg.normal_junction_threshold, cfg.extend_junction_threshold,
           cfg.min_boundary_log_ratio, cfg.min_transcript_coverage,
           tuple(cfg.max_decompose_error_ratio))
    cached = getattr(cfg, "_native_cfg_cache", None)
    if cached is not None and cached[0] == tok:
        return cached[1], cached[2]
    ints = np.asarray(tok[:CFG_NI], dtype=np.int64)
    dbls = np.asarray(tok[CFG_NI:-1] + tok[-1], dtype=np.float64)
    assert ints.size == CFG_NI and dbls.size == CFG_ND
    cfg._native_cfg_cache = (tok, ints, dbls)
    return ints, dbls


# value-keyed registry of distinct native cfg blocks: _scan_rec carries a
# small index instead of per-bundle cfg arrays, so the batch marshal can
# gather cfg rows with one np.take (the per-bundle Python appends were
# the marshal hot loop).  Rebuilt lazily; rows never mutate in-place.
_CFG_TAB = {"key2idx": {}, "ints": [], "dbls": [], "stack": None}


def _cfg_index(cfg):
    """Stable index of this cfg's native (ints, dbls) block."""
    ci, cd = _cfg_arrays(cfg)
    cached = getattr(cfg, "_native_cfg_idx", None)
    tok = cfg._native_cfg_cache[0]
    if cached is not None and cached[0] == tok:
        return cached[1]
    key = ci.tobytes() + cd.tobytes()
    idx = _CFG_TAB["key2idx"].get(key)
    if idx is None:
        idx = len(_CFG_TAB["ints"])
        _CFG_TAB["key2idx"][key] = idx
        _CFG_TAB["ints"].append(ci)
        _CFG_TAB["dbls"].append(cd)
        _CFG_TAB["stack"] = None
    cfg._native_cfg_idx = (tok, idx)
    return idx


def _cfg_tables():
    st = _CFG_TAB["stack"]
    if st is None:
        st = (np.stack(_CFG_TAB["ints"]), np.stack(_CFG_TAB["dbls"]))
        _CFG_TAB["stack"] = st
    return st


def preview_bundle_native(sb, cfg):
    """Run previewer._process on a raw ScanBundle natively; returns the list
    of fragment inner distances, or None when the core is unavailable."""
    if not native_core_available():
        return None
    lib = _load_lib()
    ci, cd = _cfg_arrays(cfg)
    fixed = sb.fixed
    n = lib.core_preview_bundle(
        fixed.shape[0], fixed.ctypes.data,
        sb.coords.ctypes.data,
        sb.mev.ctypes.data, sb.mev.size // 2,
        sb.iev.ctypes.data, sb.iev.size // 2,
        sb.frgs.ctypes.data, sb.frgs.size // 2,
        sb.lpos, sb.rpos, int(fixed[0, 22]),   # strand = first hit's, like
                                               # materialize_bundle/add_hit
        ci.ctypes.data, cd.ctypes.data,
        _preview_buf().ctypes.data, None)
    return _preview_buf()[:int(n)].tolist()


def preview_chunks_available():
    if not native_core_available():
        return False
    return hasattr(_load_lib(), "core_preview_chunk")


def collect_insertsizes_chunked(reader, cfg, library_type,
                                boundary_sink=None):
    """Whole-file insert-size collection with ONE native call per scanner
    chunk (core_preview_chunk) instead of one per bundle; returns the
    distance histogram dict.  Cap/epoch semantics match the per-bundle scan
    (meta/previewer.py:218-235): processing stops at the first bundle of a
    different epoch after max_preview_reads distances have accumulated.

    boundary_sink=(region_len, sample_profile): piggyback the region grid
    on this decode (io/bam_native.py scan_preview_pools), eliminating the
    separate set_batch_boundaries pass over the file."""
    from ..io.bam_native import scan_params
    lib = _load_lib()
    ci, cd = _cfg_arrays(cfg)
    pr = scan_params(cfg, library_type)
    min_hits = int(cfg.min_num_hits_in_bundle)
    cap = cfg.max_preview_reads
    # ALETSCH_REF_QUIRKS: persistent per-stream interval buffers replicate
    # the reference previewer's never-flushed bundle_base buffer
    # (core.cpp quirk_preview_buffer)
    qbufs = None
    if os.environ.get("ALETSCH_REF_QUIRKS") == "1":
        qbufs = np.full(60, -1, dtype=np.int32)
    accepted = []          # per-chunk accepted distance arrays; one
    cnt = 0                # np.unique pass at the end builds the
    capped_epoch = None    # histogram (was a per-chunk dict merge)
    out_d = np.empty(1, dtype=np.int64)
    gen = reader.scan_preview_pools(pr, boundary_sink=boundary_sink)
    for meta, fixed, coords, mev, iev, frgs in gen:
        nb = meta.shape[0]
        rows = fixed.shape[0]
        if out_d.size < rows:
            out_d = np.empty(rows, dtype=np.int64)
        cnts = np.empty(nb, dtype=np.int64)
        total = lib.core_preview_chunk(
            nb, meta.ctypes.data, fixed.ctypes.data, coords.ctypes.data,
            mev.ctypes.data, iev.ctypes.data, frgs.ctypes.data,
            min_hits, ci.ctypes.data, cd.ctypes.data,
            out_d.ctypes.data, cnts.ctypes.data,
            None if qbufs is None else qbufs.ctypes.data)
        # Vectorized replay of the per-bundle loop (the Python histogram
        # loop was ~1.7 s of the 2.2 s profiling phase at production
        # scale).  Semantics preserved exactly: bundles are taken in order;
        # once the running distance count crosses `cap` at bundle b, only
        # bundles sharing b's epoch are taken until the first mismatch.
        epochs = meta[:, 9]
        take = nb                    # bundles accepted from this chunk
        stop = False
        if capped_epoch is not None:
            ne = np.nonzero(epochs != capped_epoch)[0]
            if ne.size:
                take = int(ne[0])
                stop = True
        if not stop and capped_epoch is None:
            ccum = np.cumsum(cnts[:take])
            bcap = int(np.searchsorted(ccum, cap - cnt))
            if bcap < take:
                capped_epoch = int(epochs[bcap])
                ne = np.nonzero(epochs[bcap + 1:take] != capped_epoch)[0]
                if ne.size:
                    take = bcap + 1 + int(ne[0])
                    stop = True
        naccept = int(cnts[:take].sum())
        if naccept:
            accepted.append(out_d[:naccept].copy())
            cnt += naccept
        if stop:
            gen.close()
            break
    if not accepted:
        return {}
    vals, vcnts = np.unique(np.concatenate(accepted), return_counts=True)
    return dict(zip(vals.tolist(), vcnts.tolist()))


def cluster_groups_native(gset, cfg):
    """Native bundle_group clustering rounds (core_cluster_groups); returns
    per-bundle group ids in gvv order, or None when unavailable."""
    if not native_core_available():
        return None
    lib = _load_lib()
    n = len(gset)
    pp = (ctypes.c_void_p * max(n, 1))()
    lens = np.empty(max(n, 1), dtype=np.int64)
    keep = []
    for i, bd in enumerate(gset):
        arr = getattr(bd, "_splices_arr", None)
        if arr is None or len(arr) != len(bd.splices):
            arr = np.asarray(bd.splices, dtype=np.int32)
            keep.append(arr)
        pp[i] = arr.ctypes.data if arr.size else None
        lens[i] = arr.size
    out = np.empty(max(n, 1), dtype=np.int32)
    lib.core_cluster_groups(
        n, pp, lens.ctypes.data,
        float(cfg.max_num_junctions_to_combine),
        float(cfg.max_grouping_similarity),
        float(cfg.min_grouping_similarity),
        int(cfg.max_group_size), out.ctypes.data)
    return out[:n]


def eligible(asmb, gv):
    """Native path taken only for pristine scanner bundles at verbose < 2
    (fix_missing_edges prints are the one verbose>=2 side effect)."""
    if not native_core_available():
        return False
    if asmb.cfg.verbose >= 2:
        return False
    for bd in gv:
        sf = getattr(bd, "_scan_fixed", None)
        if sf is None:
            return False
        if not getattr(bd, "_light", False) and sf.shape[0] != len(bd.hits):
            return False
        if not bd.frgs_ready:
            return False
        # pristine: no bridges applied yet (BundleBase flags every
        # frgs[k][2] write — update_bridges / eliminate_bridge /
        # filter_multialigned_hits — conservatively at entry)
        if bd._frgs_mutated:
            return False
    return True


# dispatch statistics (tests assert the native path actually fires; a
# silently broken eligibility check would otherwise just slow-path forever)
stats = {"native_groups": 0, "fallback_groups": 0,
         "mt_native_s": 0.0, "mt_replay_s": 0.0, "mt_marshal_s": 0.0}


def _marshal_group(asmb, gv, do_bridge):
    """Build the core_resolve_group / core_group_start argument list.
    Returns (args, keep): `keep` holds contiguous array copies that the
    native bundle keeps raw pointers into (init_from_scan) — a paused
    GroupRun handle must keep them alive until core_group_free."""
    n = len(gv)
    nh = np.asarray([bd._scan_fixed.shape[0] for bd in gv], dtype=np.int32)

    _empty = np.zeros(2, dtype=np.int32)
    _keep = []                      # keep contiguous copies alive

    def ptrs(arrs, pairs):
        """Per-bundle data pointers + pair counts (no concatenation)."""
        pp = (ctypes.c_void_p * n)()
        cnt = np.empty(n, dtype=np.int64)
        for i, a in enumerate(arrs):
            sz = a.size                # BEFORE the placeholder swap: an
            if sz == 0:                # empty frgs array must count as 0
                a = _empty             # pairs, not as one phantom (0,0)
            elif not a.flags.c_contiguous or a.dtype != np.int32:
                a = np.ascontiguousarray(a, dtype=np.int32)
                _keep.append(a)
            pp[i] = a.ctypes.data
            cnt[i] = sz // 2 if pairs else sz
        return pp, cnt

    fixed_p, _ = ptrs([bd._scan_fixed for bd in gv], False)
    coords_p, _ = ptrs([bd._scan_coords for bd in gv], False)
    mev_p, mev_cnt = ptrs([bd._scan_mev for bd in gv], True)
    iev_p, iev_cnt = ptrs([bd._scan_iev for bd in gv], True)
    frg_p, frg_cnt = ptrs([bd._scan_frgs for bd in gv], True)

    sid = np.asarray([bd.sp.sample_id for bd in gv], dtype=np.int32)
    strand = np.asarray([ord(bd.strand) for bd in gv], dtype=np.int32)
    lpos = np.asarray([bd.lpos for bd in gv], dtype=np.int64)
    rpos = np.asarray([bd.rpos for bd in gv], dtype=np.int64)
    ilow = np.asarray([bd.sp.insertsize_low for bd in gv], dtype=np.int64)
    ihigh = np.asarray([bd.sp.insertsize_high for bd in gv], dtype=np.int64)

    cfg_i = np.empty((n + 1) * CFG_NI, dtype=np.int64)
    cfg_d = np.empty((n + 1) * CFG_ND, dtype=np.float64)
    for b, bd in enumerate(gv):
        ci, cd = _cfg_arrays(bd.cfg)
        cfg_i[b * CFG_NI:(b + 1) * CFG_NI] = ci
        cfg_d[b * CFG_ND:(b + 1) * CFG_ND] = cd
    ci, cd = _cfg_arrays(asmb.cfg)
    cfg_i[n * CFG_NI:] = ci
    cfg_d[n * CFG_ND:] = cd

    _keep.extend((nh, mev_cnt, iev_cnt, frg_cnt, sid, strand, lpos, rpos,
                  ilow, ihigh, cfg_i, cfg_d, fixed_p, coords_p, mev_p,
                  iev_p, frg_p, _empty))
    args = (n, 1 if do_bridge else 0,
            nh.ctypes.data,
            fixed_p, coords_p,
            mev_p, mev_cnt.ctypes.data,
            iev_p, iev_cnt.ctypes.data,
            frg_p, frg_cnt.ctypes.data,
            sid.ctypes.data, strand.ctypes.data, lpos.ctypes.data,
            rpos.ctypes.data, ilow.ctypes.data, ihigh.ctypes.data,
            cfg_i.ctypes.data, cfg_d.ctypes.data)
    return args, _keep


def _fetch_out(lib, h, sizes_fn, fill_fn):
    sizes = (ctypes.c_int64 * 3)()
    sizes_fn(h, sizes)
    ng, nt, ne = int(sizes[0]), int(sizes[1]), int(sizes[2])
    g_sid = np.zeros(max(ng, 1), dtype=np.int32)
    g_sub = np.zeros(max(ng, 1), dtype=np.int32)
    t_group = np.zeros(max(nt, 1), dtype=np.int32)
    t_pathi = np.zeros(max(nt, 1), dtype=np.int32)
    t_strand = np.zeros(max(nt, 1), dtype=np.int32)
    t_count1 = np.zeros(max(nt, 1), dtype=np.int64)
    t_cov = np.zeros(max(nt, 1), dtype=np.float64)
    t_conf = np.zeros(max(nt, 1), dtype=np.float64)
    t_abd = np.zeros(max(nt, 1), dtype=np.float64)
    t_nexons = np.zeros(max(nt, 1), dtype=np.int32)
    exons = np.zeros(max(ne, 1), dtype=np.int64)
    feats = np.zeros(max(nt * len(FEATURE_COLUMNS), 1), dtype=np.float64)
    fill_fn(h, g_sid.ctypes.data, g_sub.ctypes.data,
            t_group.ctypes.data, t_pathi.ctypes.data,
            t_strand.ctypes.data, t_count1.ctypes.data,
            t_cov.ctypes.data, t_conf.ctypes.data,
            t_abd.ctypes.data, t_nexons.ctypes.data,
            exons.ctypes.data, feats.ctypes.data)
    return (ng, nt, g_sid, g_sub, t_group, t_pathi, t_strand, t_count1,
            t_cov, t_conf, t_abd, t_nexons, exons, feats)


def launch_group_native(asmb, gv, do_bridge):
    """Marshal the group and run the native assembly; returns the raw
    replay tuple, or None when ineligible.  Safe on a worker thread: the C
    call releases the GIL and reads only the bundles' scanner arrays —
    nothing shared is written until finish_group_native replays on the
    main thread (incubator pipelines launches across groups)."""
    if not eligible(asmb, gv):
        return None
    lib = _load_lib()
    args, _keep = _marshal_group(asmb, gv, do_bridge)
    h = lib.core_resolve_group(*args)
    out = _fetch_out(lib, h, lib.core_out_sizes, lib.core_out_fill)
    lib.core_out_free(h)
    return out


class GroupHandle:
    """A paused native GroupRun: keeps the scanner arrays the native
    bundles point into alive until core_group_free.  `pause_kind` is the
    last core_group_advance result: 0 done, 1 greedy pause, 2 bridge
    pause (`paused` is its truthiness)."""

    __slots__ = ("h", "asmb", "gv", "keep", "pause_kind")

    def __init__(self, h, asmb, gv, keep, pause_kind):
        self.h = h
        self.asmb = asmb
        self.gv = gv
        self.keep = keep
        self.pause_kind = pause_kind

    @property
    def paused(self):
        return self.pause_kind != 0


def bridge_pause_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_bridge_export")


def support_pause_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_support_export")


def start_group_device(asmb, gv, do_bridge, minv, bridge_dev=False,
                       support_dev=False, ladder_dev=False):
    """Begin a device-paused group assembly; returns a GroupHandle, or
    None when the group is ineligible for the native core.  bridge_dev
    additionally pauses at every bridging pier-DP instance; support_dev at
    the cross-sample junction-support reduce; ladder_dev at the scallop
    resolution ladder (pause kind 4)."""
    if not eligible(asmb, gv):
        return None
    lib = _load_lib()
    if not hasattr(lib, "core_group_start"):
        return None
    if bridge_dev and not hasattr(lib, "core_bridge_export"):
        bridge_dev = False
    if support_dev and not hasattr(lib, "core_support_export"):
        support_dev = False
    args, keep = _marshal_group(asmb, gv, do_bridge)
    h = lib.core_group_start(*(args + (int(minv), 1 if bridge_dev else 0,
                                       1 if support_dev else 0)))
    if ladder_dev and hasattr(lib, "core_group_set_ladder"):
        lib.core_group_set_ladder(h, 1)
    kind = int(lib.core_group_advance(h))
    return GroupHandle(h, asmb, gv, keep, kind)


def fused_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_greedy_export_fused")


# cumulative fused-drain agreement stats: [agreeing paths, device paths]
fused_stats = np.zeros(2, dtype=np.int64)


def greedy_export_fused(gh, rows, maxv):
    """Export the paused graph for the fused drain into one batch row
    (rows = (W, P, sink, scal) slices); returns V > 0 or 0 (ineligible)."""
    lib = _load_lib()
    W, P, sink, scal = rows
    return int(lib.core_greedy_export_fused(
        gh.h, W.ctypes.data, P.ctypes.data, maxv,
        sink.ctypes.data, scal.ctypes.data))


def greedy_consume_fused(gh, ws_row, paths_row, npaths, maxv, trust):
    """Feed one graph's fused-drain results back (paths consumed in trust
    mode, compared in verify mode; host drain always re-checked); returns
    the next pause kind."""
    lib = _load_lib()
    pm = np.ascontiguousarray(paths_row, dtype=np.uint8)
    ws = np.ascontiguousarray(ws_row, dtype=np.float64)
    gh.pause_kind = int(lib.core_greedy_consume_fused(
        gh.h, ws.ctypes.data, pm.ctypes.data, int(npaths), maxv,
        0 if trust else 1, fused_stats.ctypes.data))
    return gh.pause_kind


def ladder_pause_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_ladder_export")


# cumulative ladder agreement stats: [consumed/agreeing, device decisions]
ladder_stats = np.zeros(2, dtype=np.int64)


def ladder_export(gh, rows, maxv, emax, hmax, lmax, dmax):
    """Export the ladder-paused graph into one DeviceLadder batch row
    (rows = DeviceLadder.row(i)); returns V > 0 or 0 (ineligible)."""
    lib = _load_lib()
    ptrs = [r.ctypes.data for r in rows]
    return int(lib.core_ladder_export(
        gh.h, *ptrs, int(maxv), int(emax), int(hmax), int(lmax),
        int(dmax)))


def ladder_consume(gh, arm_row, tgt_row, ndec, status, trust):
    """Feed one graph's device decision log back (replayed in trust mode,
    agreement-compared in verify mode; host ladder always completes the
    router rungs); returns the next pause kind."""
    lib = _load_lib()
    arm = np.ascontiguousarray(arm_row, dtype=np.int32)
    tgt = np.ascontiguousarray(tgt_row, dtype=np.int32)
    gh.pause_kind = int(lib.core_ladder_consume(
        gh.h, arm.ctypes.data, tgt.ctypes.data, int(ndec), int(status),
        0 if trust else 1, ladder_stats.ctypes.data))
    return gh.pause_kind


def ladder_solve_host(gh):
    """Run phase1 on the host for a ladder-ineligible graph."""
    lib = _load_lib()
    gh.pause_kind = int(lib.core_ladder_solve_host(gh.h))
    return gh.pause_kind


# scallop.cc:47-173 rung order; indices 0-3 are the device-coverable
# prefix (ops/ladder_kernel.py), 4-10 the host-only router rungs
LADDER_RUNGS = (
    "broken_vertex", "trivial_vertex_fast", "trivial_vertex",
    "smallest_edges", "unsplittable_single_d1", "splittable_pure_d1",
    "unsplittable_single_ratio", "splittable_pure_ratio",
    "unsplittable_single_inf", "splittable_pure_inf", "trivial_vertex_2")


def ladder_histogram(reset=False):
    """Process-wide per-rung resolution-ladder fire counts, or None when
    the native core is unavailable.  Pins the device-prefix coverage
    claim: the share of fires landing in rungs 0-3 is exactly the share
    of ladder iterations the batched device ladder can absorb."""
    if not native_core_available():
        return None
    lib = _load_lib()
    if not hasattr(lib, "core_ladder_hist"):
        return None
    out = np.zeros(11, dtype=np.int64)
    lib.core_ladder_hist(out.ctypes.data, 1 if reset else 0)
    return dict(zip(LADDER_RUNGS, out.tolist()))


def bench_ladder_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_bench_ladder")


def bench_ladder(nv, eoff, es, et, ew, estr, hoff, hvoff, hverts, hcnts,
                 cfg):
    """Run the genuine native host ladder over a flattened batch of graphs
    + hyper node-lists (crossover measurement; see core_bench_ladder).
    Returns (ndec [B] i32, build_s, ladder_s)."""
    lib = _load_lib()
    _bind(lib)
    B = len(nv)
    ci, cd = _cfg_arrays(cfg)
    a = [np.ascontiguousarray(x, dtype=np.int32)
         for x in (nv, eoff, es, et)]
    ew = np.ascontiguousarray(ew, dtype=np.float64)
    estr = np.ascontiguousarray(estr, dtype=np.int32)
    b = [np.ascontiguousarray(x, dtype=np.int32)
         for x in (hoff, hvoff, hverts)]
    hcnts = np.ascontiguousarray(hcnts, dtype=np.int64)
    ndec = np.zeros(B, dtype=np.int32)
    nanos = np.zeros(2, dtype=np.int64)
    lib.core_bench_ladder(
        B, a[0].ctypes.data, a[1].ctypes.data, a[2].ctypes.data,
        a[3].ctypes.data, ew.ctypes.data, estr.ctypes.data,
        b[0].ctypes.data, b[1].ctypes.data, b[2].ctypes.data,
        hcnts.ctypes.data, ci.ctypes.data, cd.ctypes.data,
        ndec.ctypes.data, nanos.ctypes.data)
    return ndec, nanos[0] * 1e-9, nanos[1] * 1e-9


def bench_drain_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_bench_drain")


def bench_drain(W, P, sink, scal, maxp):
    """Run the genuine native host drain over a dense [B, V, V] fused-drain
    batch (same inputs the device dispatch receives) and return
    (ws [B,maxp] f64, npaths [B] i32, build_s, drain_s).  Calibrates the
    host side of the device-crossover model (meta/device_wave.py) and the
    bench crossover table (bench.py)."""
    lib = _load_lib()
    _bind(lib)
    W = np.ascontiguousarray(W, dtype=np.float64)
    P = np.ascontiguousarray(P, dtype=np.int32)
    sink = np.ascontiguousarray(sink, dtype=np.int32)
    scal = np.ascontiguousarray(scal, dtype=np.float64)
    B, V, _ = W.shape
    ws = np.zeros((B, maxp), dtype=np.float64)
    np_out = np.zeros(B, dtype=np.int32)
    nanos = np.zeros(2, dtype=np.int64)
    lib.core_bench_drain(W.ctypes.data, P.ctypes.data, sink.ctypes.data,
                         scal.ctypes.data, B, V, int(maxp),
                         ws.ctypes.data, np_out.ctypes.data,
                         nanos.ctypes.data)
    return ws, np_out, nanos[0] * 1e-9, nanos[1] * 1e-9


def greedy_export(gh, Wrow, maxv):
    """Export the paused graph's adjacency into Wrow ([maxv, maxv] f32
    slice); returns V > 0 or 0 (device-ineligible)."""
    lib = _load_lib()
    return int(lib.core_greedy_export(gh.h, Wrow.ctypes.data, maxv))


def greedy_step(gh, table_row):
    lib = _load_lib()
    # raw ctypes.data: the row must be dense (relay device views are not)
    table_row = np.ascontiguousarray(table_row, dtype=np.float32)
    gh.pause_kind = int(lib.core_greedy_step(gh.h, table_row.ctypes.data))
    return gh.pause_kind


def greedy_solve_host(gh):
    lib = _load_lib()
    gh.pause_kind = int(lib.core_greedy_solve_host(gh.h))
    return gh.pause_kind


def bridge_export(gh, rows, K, S):
    """Export the paused bridging instance into one DeviceBridge batch row
    (rows = (P, Wt, Lv, tgt) slices); returns the window size > 0, or 0
    when this instance must be solved on host."""
    lib = _load_lib()
    P, Wt, Lv, tgt = rows
    V, E = P.shape
    T = tgt.shape[0]
    return int(lib.core_bridge_export(
        gh.h, P.ctypes.data, Wt.ctypes.data, Lv.ctypes.data,
        tgt.ctypes.data, V, E, T, int(K), int(S)))


def bridge_pending(gh):
    """Number of unsolved pier-DP instances across the paused queue (the
    whole bridging phase pauses once; VERDICT r2 #1)."""
    lib = _load_lib()
    return int(lib.core_bridge_pending(gh.h))


def bridge_export_at(gh, j, rows, K, S):
    """Export the j-th remaining instance (flattened queue order) without
    advancing; returns the window size > 0, or 0 (host fallback)."""
    lib = _load_lib()
    P, Wt, Lv, tgt = rows
    V, E = P.shape
    T = tgt.shape[0]
    return int(lib.core_bridge_export_at(
        gh.h, int(j), P.ctypes.data, Wt.ctypes.data, Lv.ctypes.data,
        tgt.ctypes.data, V, E, T, int(K), int(S)))


def bridge_step(gh, ostk, par, pix, K, S):
    """Feed one instance's device results ([T,K,S] stacks + [V,K] parent /
    entry-index tables) back; returns the next pause kind."""
    lib = _load_lib()
    # raw ctypes.data: rows must be dense (relay device views are not)
    ostk = np.ascontiguousarray(ostk, dtype=np.int32)
    par = np.ascontiguousarray(par, dtype=np.int32)
    pix = np.ascontiguousarray(pix, dtype=np.int32)
    gh.pause_kind = int(lib.core_bridge_step(
        gh.h, ostk.ctypes.data, par.ctypes.data, pix.ctypes.data,
        par.shape[0], ostk.shape[0], int(K), int(S)))
    return gh.pause_kind


def bridge_solve_host(gh):
    lib = _load_lib()
    gh.pause_kind = int(lib.core_bridge_solve_host(gh.h))
    return gh.pause_kind


def support_export(gh, jw_row):
    """Export the paused group's per-(sample-slot, junction) weights into
    one DeviceSupport batch row ([NS, J] f32); returns the number of
    offloadable junctions (0 = solve on host)."""
    lib = _load_lib()
    NS, J = jw_row.shape
    return int(lib.core_support_export(gh.h, jw_row.ctypes.data, NS, J))


def support_step(gh, sums_row):
    """Feed the [J] f32 device sums back; returns the next pause kind."""
    lib = _load_lib()
    # raw ctypes.data: the row must be dense (relay device views are not)
    sums_row = np.ascontiguousarray(sums_row, dtype=np.float32)
    gh.pause_kind = int(lib.core_support_step(gh.h, sums_row.ctypes.data))
    return gh.pause_kind


def support_solve_host(gh):
    lib = _load_lib()
    gh.pause_kind = int(lib.core_support_solve_host(gh.h))
    return gh.pause_kind


def _nts_target(asmb):
    """The native transcript-set handle when asmb.tmerge is one (the
    default production path), else None (Python replay)."""
    from .native_tset import NativeTSet
    return asmb.tmerge if isinstance(asmb.tmerge, NativeTSet) else None


def finish_group_device(gh):
    """Fetch + replay a completed handle's transcripts (group order)."""
    assert not gh.paused
    lib = _load_lib()
    stats["native_groups"] += 1
    tset = _nts_target(gh.asmb)
    if tset is not None:
        from .native_tset import merge_group_nts
        a = gh.asmb
        merge_group_nts(gh.h, tset, a.rid, a.gid, a.instance,
                        gh.gv[0].chrm, a.cfg.skip_single_exon_transcripts)
        lib.core_group_free(gh.h)
        gh.h = None
        gh.keep = None
        for bd in gh.gv:
            bd.clear()
        return
    out = _fetch_out(lib, gh.h, lib.core_group_sizes, lib.core_group_fill)
    lib.core_group_free(gh.h)
    gh.h = None
    gh.keep = None
    _replay_transcripts(gh.asmb, gh.gv[0].chrm, *out)
    for bd in gh.gv:
        bd.clear()


def finish_group_native(asmb, gv, out):
    """Replay a launch_group_native result into the transcript sets and
    release the bundles (main thread, group order — determinism)."""
    stats["native_groups"] += 1
    _replay_transcripts(asmb, gv[0].chrm, *out)
    for bd in gv:
        bd.clear()


def batch_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_resolve_groups_mt")


def _marshal_batch_fast(asms, gvs, do_bridge, nthreads):
    """Vectorized marshal: every bundle carries a flat _scan_rec tuple
    (generator.py scan-time precompute), so the per-bundle work is ONE
    list append; columns come from one bulk np.array conversion and cfg
    rows from one np.take over the cfg registry.  Returns None when any
    bundle lacks a record (caller falls back to the general loop)."""
    lib = _load_lib()
    n_groups = len(gvs)
    recs = []
    ap = recs.append
    try:
        for gv in gvs:
            for bd in gv:
                ap(bd._scan_rec)
    except AttributeError:
        return None
    tot = len(recs)
    arr = np.array(recs, dtype=np.int64)        # [tot, 16]
    if arr.ndim != 2 or arr.shape[1] != 16:
        return None
    grp_nb = np.asarray([len(gv) for gv in gvs], dtype=np.int32)
    nh = arr[:, 5].astype(np.int32)
    # pointer tables: a C-contiguous int64 column IS a void*[] on LP64 —
    # cast its buffer instead of building a ctypes array element-wise
    # (5 x tot c_void_p constructions were the marshal hot spot)
    vpp = ctypes.POINTER(ctypes.c_void_p)

    def pcol(col):
        a = np.ascontiguousarray(col)
        return a, ctypes.cast(int(a.ctypes.data), vpp)

    fx_a, fixed_p = pcol(arr[:, 0])
    co_a, coords_p = pcol(arr[:, 1])
    me_a, mev_p = pcol(arr[:, 2])
    ie_a, iev_p = pcol(arr[:, 3])
    fr_a, frg_p = pcol(arr[:, 4])
    mev_cnt = np.ascontiguousarray(arr[:, 6])
    iev_cnt = np.ascontiguousarray(arr[:, 7])
    frg_cnt = np.ascontiguousarray(arr[:, 8])
    lpos = np.ascontiguousarray(arr[:, 9])
    rpos = np.ascontiguousarray(arr[:, 10])
    strand = arr[:, 11].astype(np.int32)
    sid = arr[:, 12].astype(np.int32)
    ilow = np.ascontiguousarray(arr[:, 13])
    ihigh = np.ascontiguousarray(arr[:, 14])
    # cfg rows: per-group [bundle cfgs..., group cfg] interleave
    idx = np.empty(tot + n_groups, dtype=np.int64)
    pos = boff = 0
    for g, (asmb, gv) in enumerate(zip(asms, gvs)):
        nb = len(gv)
        idx[pos:pos + nb] = arr[boff:boff + nb, 15]
        idx[pos + nb] = _cfg_index(asmb.cfg)
        pos += nb + 1
        boff += nb
    ti, td = _cfg_tables()
    cfg_i = np.ascontiguousarray(ti[idx].reshape(-1))
    cfg_d = np.ascontiguousarray(td[idx].reshape(-1))
    keep = [grp_nb, nh, mev_cnt, iev_cnt, frg_cnt, sid, strand, lpos,
            rpos, ilow, ihigh, cfg_i, cfg_d, fx_a, co_a, me_a,
            ie_a, fr_a]
    args = (n_groups, int(nthreads), 1 if do_bridge else 0,
            grp_nb.ctypes.data, nh.ctypes.data,
            fixed_p, coords_p,
            mev_p, mev_cnt.ctypes.data,
            iev_p, iev_cnt.ctypes.data,
            frg_p, frg_cnt.ctypes.data,
            sid.ctypes.data, strand.ctypes.data, lpos.ctypes.data,
            rpos.ctypes.data, ilow.ctypes.data, ihigh.ctypes.data,
            cfg_i.ctypes.data, cfg_d.ctypes.data)
    return args, keep


def _marshal_batch(asms, gvs, do_bridge, nthreads):
    """Build the core_resolve_groups_mt[_async] argument tuple.  Returns
    (call_args, keep): `keep` holds contiguous copies the C++ workers read
    from — an async caller must keep it (plus the bundles) alive until
    core_batch_join."""
    fast = _marshal_batch_fast(asms, gvs, do_bridge, nthreads)
    if fast is not None:
        return fast
    lib = _load_lib()
    n_groups = len(gvs)
    tot = sum(len(gv) for gv in gvs)
    grp_nb = np.asarray([len(gv) for gv in gvs], dtype=np.int32)
    _empty = np.zeros(2, dtype=np.int32)
    _keep = [_empty]
    _eptr = _empty.ctypes.data

    # plain-list accumulation + one bulk conversion per column: per-bundle
    # numpy scalar stores and .ctypes.data lookups were the dominant cost
    # of this loop (the scan layer precomputes each bundle's pool pointers
    # on the worker thread — io/bam_native.py _scan_chunks)
    nh_l = []
    fx_l = []
    co_l = []
    me_l = []
    ie_l = []
    fr_l = []
    mec_l = []
    iec_l = []
    frc_l = []
    sid_l = []
    str_l = []
    lp_l = []
    rp_l = []
    il_l = []
    ih_l = []
    cfgi_l = []
    cfgd_l = []

    def slowptr(a, pairs):
        sz = a.size                    # BEFORE the placeholder swap: an
        if sz == 0:                    # empty frgs array must count as 0
            return _eptr, 0            # pairs, not as one phantom (0,0)
        if not a.flags.c_contiguous or a.dtype != np.int32:
            a = np.ascontiguousarray(a, dtype=np.int32)
            _keep.append(a)
        return a.ctypes.data, (sz // 2 if pairs else sz)

    for asmb, gv in zip(asms, gvs):
        for bd in gv:
            p = getattr(bd, "_scan_ptrs", None)
            if p is not None:
                cn = bd._scan_cnts
                fx_l.append(p[0])
                co_l.append(p[1])
                me_l.append(p[2])
                ie_l.append(p[3])
                fr_l.append(p[4])
                nh_l.append(cn[0])
                mec_l.append(cn[1])
                iec_l.append(cn[2])
                frc_l.append(cn[3])
            else:
                nh_l.append(bd._scan_fixed.shape[0])
                fx_l.append(slowptr(bd._scan_fixed, False)[0])
                co_l.append(slowptr(bd._scan_coords, False)[0])
                pm, cm = slowptr(bd._scan_mev, True)
                pi, ci_ = slowptr(bd._scan_iev, True)
                pf, cf = slowptr(bd._scan_frgs, True)
                me_l.append(pm)
                ie_l.append(pi)
                fr_l.append(pf)
                mec_l.append(cm)
                iec_l.append(ci_)
                frc_l.append(cf)
            sp = bd.sp
            sid_l.append(sp.sample_id)
            str_l.append(ord(bd.strand))
            lp_l.append(bd.lpos)
            rp_l.append(bd.rpos)
            il_l.append(sp.insertsize_low)
            ih_l.append(sp.insertsize_high)
            ci, cd = _cfg_arrays(bd.cfg)
            cfgi_l.append(ci)
            cfgd_l.append(cd)
        ci, cd = _cfg_arrays(asmb.cfg)
        cfgi_l.append(ci)
        cfgd_l.append(cd)
    nh = np.asarray(nh_l, dtype=np.int32)
    fixed_p = (ctypes.c_void_p * tot)(*fx_l)
    coords_p = (ctypes.c_void_p * tot)(*co_l)
    mev_p = (ctypes.c_void_p * tot)(*me_l)
    iev_p = (ctypes.c_void_p * tot)(*ie_l)
    frg_p = (ctypes.c_void_p * tot)(*fr_l)
    mev_cnt = np.asarray(mec_l, dtype=np.int64)
    iev_cnt = np.asarray(iec_l, dtype=np.int64)
    frg_cnt = np.asarray(frc_l, dtype=np.int64)
    sid = np.asarray(sid_l, dtype=np.int32)
    strand = np.asarray(str_l, dtype=np.int32)
    lpos = np.asarray(lp_l, dtype=np.int64)
    rpos = np.asarray(rp_l, dtype=np.int64)
    ilow = np.asarray(il_l, dtype=np.int64)
    ihigh = np.asarray(ih_l, dtype=np.int64)
    cfg_i = np.concatenate(cfgi_l) if cfgi_l else \
        np.empty(0, dtype=np.int64)
    cfg_d = np.concatenate(cfgd_l) if cfgd_l else \
        np.empty(0, dtype=np.float64)
    assert cfg_i.size == (tot + n_groups) * CFG_NI
    _keep.extend((grp_nb, nh, mev_cnt, iev_cnt, frg_cnt, sid, strand,
                  lpos, rpos, ilow, ihigh, cfg_i, cfg_d,
                  fixed_p, coords_p, mev_p, iev_p, frg_p))
    args = (n_groups, int(nthreads), 1 if do_bridge else 0,
            grp_nb.ctypes.data, nh.ctypes.data,
            fixed_p, coords_p,
            mev_p, mev_cnt.ctypes.data,
            iev_p, iev_cnt.ctypes.data,
            frg_p, frg_cnt.ctypes.data,
            sid.ctypes.data, strand.ctypes.data, lpos.ctypes.data,
            rpos.ctypes.data, ilow.ctypes.data, ihigh.ctypes.data,
            cfg_i.ctypes.data, cfg_d.ctypes.data)
    return args, _keep


def _batch_eligible(asms, gvs):
    if not batch_available():
        return False
    for asmb, gv in zip(asms, gvs):
        if not eligible(asmb, gv):
            return False
    return True


def _replay_batch_nts(lib, h, asms, gvs):
    """Native-set replay of a whole BatchOut wave: ONE C call merges every
    group's transcripts into its target set in group order (the C++ twin
    of _replay_batch; byte parity is differential-fuzz-enforced)."""
    from .native_tset import merge_batch_nts
    merge_batch_nts(h, asms, gvs[0][0].chrm)
    lib.core_batch_free(h)
    stats["native_groups"] += len(asms)
    for gv in gvs:
        for bd in gv:
            bd.clear()


def _batch_nts_targets(asms):
    """True when EVERY group of the wave replays into a native set (mixed
    waves fall back to the Python replay for all groups — per-group
    interleaving across set kinds would reorder merges)."""
    if not asms:
        return False
    from .native_tset import NativeTSet
    return all(isinstance(a.tmerge, NativeTSet) for a in asms)


def _replay_batch(lib, h, asms, gvs):
    """Fetch + replay every group's outputs in group order, then free.

    One sizes call + one fill call for the WHOLE wave (concatenated
    buffers, per-group numpy views) instead of two ctypes crossings and
    14 allocations per group."""
    n = len(asms)
    if not hasattr(lib, "core_batch_fill_all"):
        for g, (asmb, gv) in enumerate(zip(asms, gvs)):
            out = _fetch_out(
                lib, h,
                lambda hh, s3, g=g: lib.core_batch_sizes(hh, g, s3),
                lambda hh, *a, g=g: lib.core_batch_fill(hh, g, *a))
            finish_group_native(asmb, gv, out)
        lib.core_batch_free(h)
        return
    sizes = np.zeros(3 * max(n, 1), dtype=np.int64)
    lib.core_batch_sizes_all(h, n, sizes.ctypes.data)
    sz = sizes.reshape(-1, 3)
    G = int(sz[:n, 0].sum())
    T = int(sz[:n, 1].sum())
    E = int(sz[:n, 2].sum())
    nf = len(FEATURE_COLUMNS)
    g_sid = np.zeros(max(G, 1), dtype=np.int32)
    g_sub = np.zeros(max(G, 1), dtype=np.int32)
    t_group = np.zeros(max(T, 1), dtype=np.int32)
    t_pathi = np.zeros(max(T, 1), dtype=np.int32)
    t_strand = np.zeros(max(T, 1), dtype=np.int32)
    t_count1 = np.zeros(max(T, 1), dtype=np.int64)
    t_cov = np.zeros(max(T, 1), dtype=np.float64)
    t_conf = np.zeros(max(T, 1), dtype=np.float64)
    t_abd = np.zeros(max(T, 1), dtype=np.float64)
    t_nexons = np.zeros(max(T, 1), dtype=np.int32)
    exons = np.zeros(max(E, 1), dtype=np.int64)
    feats = np.zeros(max(T * nf, 1), dtype=np.float64)
    lib.core_batch_fill_all(
        h, n, g_sid.ctypes.data, g_sub.ctypes.data, t_group.ctypes.data,
        t_pathi.ctypes.data, t_strand.ctypes.data, t_count1.ctypes.data,
        t_cov.ctypes.data, t_conf.ctypes.data, t_abd.ctypes.data,
        t_nexons.ctypes.data, exons.ctypes.data, feats.ctypes.data)
    t_hash = None
    if hasattr(lib, "core_batch_hashes"):
        t_hash = np.zeros(max(T, 1), dtype=np.uint64)
        lib.core_batch_hashes(h, n, t_hash.ctypes.data)
        t_hash = t_hash.tolist()
    lib.core_batch_free(h)
    go = to = eo = 0
    for g, (asmb, gv) in enumerate(zip(asms, gvs)):
        ng, nt, ne = int(sz[g, 0]), int(sz[g, 1]), int(sz[g, 2])
        out = (ng, nt, g_sid[go:go + ng], g_sub[go:go + ng],
               t_group[to:to + nt], t_pathi[to:to + nt],
               t_strand[to:to + nt], t_count1[to:to + nt],
               t_cov[to:to + nt], t_conf[to:to + nt], t_abd[to:to + nt],
               t_nexons[to:to + nt], exons[eo:eo + ne],
               feats[to * nf:(to + nt) * nf],
               None if t_hash is None else t_hash[to:to + nt])
        finish_group_native(asmb, gv, out)
        go += ng
        to += nt
        eo += ne


def resolve_groups_native_mt(asms, gvs, do_bridge, nthreads):
    """Assemble every group of a region wave in ONE native call running on
    a C++ thread pool (core_resolve_groups_mt): group-level parallelism
    without any GIL handoff — Python-side pool threading of the ~2-3 ms
    per-group calls was a measured loss (incubator._assemble_groups
    notes).  Returns True when handled (replays + clears bundles in group
    order, byte-identical to the serial path), False when any group is
    ineligible (caller falls back)."""
    if not _batch_eligible(asms, gvs):
        return False
    import time as _time
    _t0 = _time.perf_counter()
    lib = _load_lib()
    args, _keep = _marshal_batch(asms, gvs, do_bridge, nthreads)
    _t1 = _time.perf_counter()
    stats["mt_marshal_s"] += _t1 - _t0
    h = lib.core_resolve_groups_mt(*args)
    del _keep
    _t2 = _time.perf_counter()
    stats["mt_native_s"] += _t2 - _t1
    if _batch_nts_targets(asms):
        _replay_batch_nts(lib, h, asms, gvs)
    else:
        _replay_batch(lib, h, asms, gvs)
    stats["mt_replay_s"] += _time.perf_counter() - _t2
    return True


class MtJob:
    """An in-flight async batch (core_resolve_groups_mt_async): the
    incubator overlaps region r's native assembly with region r-1's
    Python-side replay (meta/incubator.py pipelined waves).  Holds the
    bundles and the marshalling copies alive until join().  When `merged`
    the native job already replayed every group into its target set on
    the worker thread (core_resolve_groups_mt_async_merge) — join only
    frees and clears."""
    __slots__ = ("jh", "asms", "gvs", "_keep", "merged")

    def __init__(self, jh, asms, gvs, keep, merged=False):
        self.jh = jh
        self.asms = asms
        self.gvs = gvs
        self._keep = keep
        self.merged = merged

    def join(self):
        """Block until the pool drains, then replay in group order —
        byte-identical to resolve_groups_native_mt."""
        import time as _time
        lib = _load_lib()
        _t0 = _time.perf_counter()
        h = lib.core_batch_join(self.jh)
        self.jh = None
        self._keep = None
        _t1 = _time.perf_counter()
        stats["mt_native_s"] += _t1 - _t0
        if self.merged:
            lib.core_batch_free(h)
            stats["native_groups"] += len(self.asms)
            # no per-bundle clear: the replay already ran in C++ and the
            # bundles (plus their scanner-pool views) die with this MtJob
            # at return — the 20k-iteration clear loop bought nothing
        elif _batch_nts_targets(self.asms):
            _replay_batch_nts(lib, h, self.asms, self.gvs)
        else:
            _replay_batch(lib, h, self.asms, self.gvs)
        stats["mt_replay_s"] += _time.perf_counter() - _t1


def async_batch_available():
    lib = _load_lib()
    return lib is not None and hasattr(lib, "core_resolve_groups_mt_async")


def _maybe_capture_batch(lib, args):
    """Diagnostic: dump this batch's full argument set for the offline
    gprof replay harness (native/replay_batch.cpp).  Off unless
    ALETSCH_CAPTURE_BATCH=<path-prefix> is set."""
    prefix = os.environ.get("ALETSCH_CAPTURE_BATCH")
    if not prefix or not hasattr(_load_lib(), "core_batch_capture"):
        return
    n = stats.get("capture_n", 0)
    stats["capture_n"] = n + 1
    path = ("%s_%04d.bin" % (prefix, n)).encode()
    lib.core_batch_capture(args[0], args[2], *args[3:], path)


def launch_groups_native_mt(asms, gvs, do_bridge, nthreads):
    """Start the whole wave's group assembly on the native pool and return
    an MtJob immediately (None when any group is native-ineligible).  The
    caller MUST call .join() before reading any transcript set the wave
    writes into."""
    if not async_batch_available() or not _batch_eligible(asms, gvs):
        return None
    import time as _time
    _t0 = _time.perf_counter()
    lib = _load_lib()
    args, keep = _marshal_batch(asms, gvs, do_bridge, nthreads)
    _maybe_capture_batch(lib, args)
    merged = False
    if hasattr(lib, "core_resolve_groups_mt_async_merge") \
            and _batch_nts_targets(asms) \
            and os.environ.get("ALETSCH_MT_MERGE", "1") != "0":
        n = len(asms)
        hs = (ctypes.c_void_p * n)(*[a.tmerge.h for a in asms])
        rid = np.asarray([a.rid for a in asms], dtype=np.int64)
        gid = np.asarray([a.gid for a in asms], dtype=np.int64)
        inst = np.asarray([a.instance for a in asms], dtype=np.int64)
        skip = np.asarray([1 if a.cfg.skip_single_exon_transcripts else 0
                           for a in asms], dtype=np.int32)
        chrm = gvs[0][0].chrm.encode()
        jh = lib.core_resolve_groups_mt_async_merge(
            *args, hs, rid.ctypes.data, gid.ctypes.data, inst.ctypes.data,
            chrm, skip.ctypes.data)
        merged = True
        stats["merged_waves"] = stats.get("merged_waves", 0) + 1
    else:
        jh = lib.core_resolve_groups_mt_async(*args)
    stats["mt_marshal_s"] += _time.perf_counter() - _t0
    return MtJob(jh, asms, gvs, keep, merged)


def resolve_group_native(asmb, gv, do_bridge):
    """Run the whole group assembly natively and replay the transcript-set
    adds exactly as Assembler.assemble_graph would.  Returns True when
    handled (bundles are cleared), False when the caller must fall back.
    When asmb.tmerge is a NativeTSet (default production path) the replay
    stays in C++ (core_out_merge_nts) — no Python transcript objects."""
    if not eligible(asmb, gv):
        stats["fallback_groups"] += 1
        return False
    tset = _nts_target(asmb)
    if tset is not None:
        from .native_tset import merge_out_nts
        lib = _load_lib()
        args, _keep = _marshal_group(asmb, gv, do_bridge)
        h = lib.core_resolve_group(*args)
        merge_out_nts(h, tset, asmb.rid, asmb.gid, asmb.instance,
                      gv[0].chrm, asmb.cfg.skip_single_exon_transcripts)
        lib.core_out_free(h)
        stats["native_groups"] += 1
        for bd in gv:
            bd.clear()
        return True
    out = launch_group_native(asmb, gv, do_bridge)
    if out is None:
        stats["fallback_groups"] += 1
        return False
    finish_group_native(asmb, gv, out)
    return True


def _replay_transcripts(asmb, chrm, ng, nt, g_sid, g_sub, t_group, t_pathi,
                        t_strand, t_count1, t_cov, t_conf, t_abd, t_nexons,
                        exons, feats, t_hash=None):
    """Rebuild Transcript objects and replay the per-graph transcript-set
    adds in Assembler.assemble_graph order (assembler.cc:1121-1136).

    Hot glue: bulk-converts the scalar columns up front, fills the feature
    dataclass with one __dict__.update instead of 41 setattrs, and inserts
    into the per-graph TranscriptSet buckets directly (equivalent to
    add_transcript's throwaway single-item set, transcript_set.cc:149-154)."""
    from ..constants import TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
    from ..core.transcript_set import TransItem, _merge_sorted_items
    from .transcript_store import new_transcript_set
    cfg = asmb.cfg
    nf = len(FEATURE_COLUMNS)
    eoff = 0
    # transcripts arrive grouped in group order (groups assembled in order)
    per_group = [[] for _ in range(ng)]
    t_group = t_group[:nt].tolist()
    t_pathi = t_pathi[:nt].tolist()
    t_strand = t_strand[:nt].tolist()
    t_count1 = t_count1[:nt].tolist()
    t_cov = t_cov[:nt].tolist()
    t_conf = t_conf[:nt].tolist()
    t_abd = t_abd[:nt].tolist()
    t_nexons = t_nexons[:nt].tolist()
    exons = exons.tolist()
    # one C-level pass builds every (start, end) pair; per-transcript
    # exon lists below are plain list slices
    epairs = list(zip(exons[0::2], exons[1::2]))
    feats = feats.tolist()
    g_gid = ["instance.%d.%d.%d.%d.0" % (asmb.rid, asmb.gid, asmb.instance,
                                         int(g_sub[g])) for g in range(ng)]
    # __new__ + template dict instead of the dataclass __init__: skips
    # field-default evaluation (incl. a throwaway TrstFeatures) per
    # transcript; features stays None on this path — feat_row carries the
    # 51 columns and write_features formats it directly (io/gtf.py)
    tmpl = Transcript().__dict__.copy()
    tmpl["seqname"] = chrm
    tmpl["source"] = gtf_source()
    tmpl["features"] = None
    tmpl["count2"] = 1
    new_t = Transcript.__new__
    for k in range(nt):
        g = t_group[k]
        t = new_t(Transcript)
        d = t.__dict__
        d.update(tmpl)
        gid = g_gid[g]
        d["gene_id"] = gid
        tid = "chr%s.%s.%d" % (chrm, gid, t_pathi[k])
        d["transcript_id"] = tid
        d["meta_tid"] = tid
        d["strand"] = chr(t_strand[k])
        cov = t_cov[k]
        d["coverage"] = cov
        d["cov2"] = cov
        d["conf"] = t_conf[k]
        d["abd"] = t_abd[k]
        d["count1"] = t_count1[k]
        nx = t_nexons[k]
        d["exons"] = epairs[eoff:eoff + nx]
        eoff += nx
        d["feat_row"] = feats[k * nf:(k + 1) * nf]
        per_group[g].append(
            (t, None if t_hash is None else t_hash[k] + 1))
    mode = TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
    skip_se = cfg.skip_single_exon_transcripts
    for g in range(ng):
        ts = new_transcript_set(chrm, asmb.tmerge.rid, cfg)
        mt = ts.mt
        sid = int(g_sid[g])
        for t, h in per_group[g]:
            if len(t.exons) <= 1 and skip_se:
                continue
            t.RPKM = 0
            if h is None:
                h = t.get_intron_chain_hashing()
            ti = TransItem(t, 1, sid)
            mine = mt.get(h)
            if mine is None:
                mt[h] = [ti]
            else:
                mt[h] = _merge_sorted_items(mine, [ti], mode,
                                            ts.single_exon_overlap)
        asmb.tmerge.add(ts, mode)
