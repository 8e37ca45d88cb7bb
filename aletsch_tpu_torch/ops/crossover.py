"""Measured device-vs-host amortization model of the 'auto' device policy.

Counterpart of aletsch_tpu/ops/crossover.py.  'auto' must decide from a
measured crossover — engage the card iff dispatch_cost(B) < B x
host_per_instance_cost — not from a fixed threshold.  This module owns
that model:

- measure(): for each batch size B, time a warm fused-drain dispatch
  (ops/greedy_fused.py: the whole repeat-until-drained loop of
  scallop/scallop.cc:2874-2897 in one launch of csrc/drain.cu) and the
  genuine native host drain on the SAME dense inputs (native
  core_bench_drain: intrusive-list graphs + compute_maximum_path_w, i.e.
  production code, not the numpy oracle).
- fit t_device(B) = a + b*B (fixed dispatch overhead + per-instance
  marginal cost: copies plus compute) and t_host(B) = c*B.  Break-even
  B* = a / (c - b) when b < c, else no crossover exists: the card can
  never amortize, whatever the batch.
- measure_ladder(), measure_similarity(), measure_coverage(),
  measure_bridge(), measure_support(): the same sweep for the other
  device forms, each against the host function named in its docstring.
- measure_policy() / calibration(): one fit PER STAGE, cached as JSON in
  the temporary directory under a name that carries the platform and the
  card, so production runs read the measured model instead of measuring
  again.  A shared fit would be wrong on a card: a drain dispatch costs
  tenths of a millisecond, a bridge dispatch tens of them, so every stage
  is asked about its own measurement
  (meta/device_wave.py auto_device_ok).

Timing: device_dispatch_s is the host clock of the solver's solve()
(copies in, launch, sync, copies out); device_resident_s is the kernel
alone on tensors that already lie on the card, between CUDA events that
the card reaches only after the host has queued them (events around a
call on an idle stream would read the host's launch instead).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from ..device import device as port_device

DEFAULT_V = 64
# v3: the bridge DP is one kernel launch (csrc/bridge.cu); a v2 file holds
# the fit of the replayed CUDA graph it replaced (v1: the ladder's replayed
# lockstep loop, before csrc/ladder.cu)
CACHE_FMT = "aletsch_torch_crossover_{platform}_{card}_v3.json"
STAGES = ("drain", "bridge", "support", "ladder", "similarity")
SPIN_CYCLES = 10_000_000    # ~5 ms of GPU clock: longer than any enqueue


def synth_batch(B, V=DEFAULT_V, seed=3, n_vertices=32, fan_in=3):
    """Deterministic synthetic drain batch at the production bench shape:
    DAGs in topo space with ~fan_in in-edges per vertex, integer weights
    (exact in f64), mincov/guard/smin at the production defaults."""
    rng = np.random.default_rng(seed)
    NEG = -1.0e18
    W = np.full((B, V, V), NEG, dtype=np.float64)
    P = np.full((B, V, V), -1, dtype=np.int32)
    sink = np.zeros(B, dtype=np.int32)
    scal = np.zeros((B, 3), dtype=np.float64)
    n = n_vertices
    for b in range(B):
        cnt = np.zeros(n, dtype=int)
        for j in range(1, n):
            for u in rng.choice(j, size=min(j, fan_in), replace=False):
                W[b, u, j] = float(rng.integers(1, 1000))
                P[b, u, j] = cnt[j]
                cnt[j] += 1
        sink[b] = n - 1
        scal[b] = (2.0, 0.01, 1e-8)
    return W, P, sink, scal


def _clamped_line(Bs, td):
    """Least-squares a + b*B with a clamped to >= 0: a negative fixed
    dispatch cost is unphysical (produced by mixing measurement windows);
    when lstsq lands negative, re-fit the slope through the origin."""
    if len(Bs) >= 2:
        A = np.stack([np.ones_like(Bs), Bs], axis=1)
        coef, *_ = np.linalg.lstsq(A, td, rcond=None)
        a, b = float(coef[0]), float(coef[1])
        if a < 0:
            a = 0.0
            b = float((Bs * td).sum() / (Bs * Bs).sum())
    else:
        a, b = float(td[0]), 0.0
    return a, b


def _fit_rows(table):
    """Rows eligible for fitting: rows measured in THIS window when at
    least two exist; rows marked "cached" (carried over from an earlier
    window) otherwise.  Returns (rows, tag) where tag records whether the
    fit mixed windows."""
    fresh = [r for r in table if not r.get("cached")]
    if len(fresh) >= 2:
        return fresh, "fresh"
    return table, ("mixed" if len(table) > len(fresh) else "fresh")


def _fit(table, host_key=None, c=None, size_key="B"):
    """(fit dict, break-even size) of a table of rows: device_dispatch_s =
    a + b*size (clamped a >= 0, same-window rows when possible) against
    the host's c*size, c the mean of host_key / size over the rows unless
    given."""
    rows, fit_window = _fit_rows(table)
    Bs = np.array([r[size_key] for r in rows], dtype=np.float64)
    td = np.array([r["device_dispatch_s"] for r in rows])
    a, b = _clamped_line(Bs, td)
    if b < 0:
        # dispatches that do not grow with the size, within their noise: a
        # negative marginal cost is as unphysical as a negative fixed one
        a, b = float(td.mean()), 0.0
    if c is None:
        th = np.array([r[host_key] for r in rows])
        c = float((th / Bs).mean())
    # b >= c: the marginal device cost alone exceeds the host cost
    be = int(np.ceil(a / (c - b))) if b < c else None
    return {"a_fixed_dispatch_s": round(a, 7),
            "b_per_graph_device_s": round(b, 9),
            "c_per_graph_host_s": round(c, 9),
            "fit_window": fit_window}, be


def platform_name(device=None):
    """"cuda" or "cpu": the type of the port's device (or the one given).
    Creates no CUDA context."""
    dev = port_device() if device is None else torch.device(device)
    return dev.type


def card_name(device=None):
    """torch.cuda.get_device_name() of the port's CUDA device; "cpu" on
    the CPU device."""
    from .mfu import device_kind
    return device_kind(device)


def _median(times):
    return float(np.median(times))


def _resident_s(fn, reps, device):
    """Median time of the kernel(s) fn() launches on tensors that already
    lie on `device`.  On a card: CUDA events, with the stream spinning
    first so that the host has queued the start event, the launch and the
    end event before the card reaches them; a repetition whose start event
    had already passed is dropped (it would hold the host's launch).  On
    the CPU device: the host clock of fn().  None when no repetition
    counts."""
    times = []
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return _median(times)
    fn()
    torch.cuda.synchronize(device)
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        held = not e0.query()
        e1.synchronize()
        if held:
            times.append(e0.elapsed_time(e1) * 1e-3)
    return _median(times) if times else None


def measure(batches=(64, 256), V=DEFAULT_V, reps=3, seed=3, device=None):
    """Measure the drain's crossover sweep.  Returns a calibration dict
    with the per-B table, the a/b/c fit, and the break-even batch size.
    One form runs: the f64 instance of csrc/drain.cu on a card, its plain
    version on the CPU device."""
    from ..meta import native_core
    from . import drain as drain_ops
    from .greedy_fused import DeviceGreedyFused, batch_from_numpy

    dev = port_device() if device is None else torch.device(device)
    table = []
    for B in sorted(set(int(b) for b in batches)):
        W, P, sink, scal = synth_batch(B, V, seed=seed)
        fd = DeviceGreedyFused(batch=B, maxv=V, device=dev)
        fd.W[:] = W
        fd.P[:] = P
        fd.sink[:] = sink
        fd.scal[:] = scal
        paths_dev, ws_dev, npaths_dev = fd.solve(B)      # warm
        dev_times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fd.solve(B)
            dev_times.append(time.perf_counter() - t0)
        # resident: the same kernel on tensors already on the device —
        # isolates compute from the copies and the host's launch, so the
        # copies' share of the marginal cost is measured, not assumed
        dargs = batch_from_numpy(W, P, sink, scal, dev)
        resident = _resident_s(
            lambda: drain_ops.drain(*dargs, fd.maxp), reps, dev)
        host_times = []
        ws_host = npaths_host = None
        build_s = 0.0
        for _ in range(reps):
            ws_host, npaths_host, build_s, drain_s = native_core.bench_drain(
                W, P, sink, scal, fd.maxp)
            host_times.append(drain_s)
        # path weights, as far as each graph's path count goes
        live = np.arange(fd.maxp)[None, :] < npaths_host[:, None]
        table.append({
            "B": B,
            "device_form": fd.stats["fused_form"],
            "device_dispatch_s": round(_median(dev_times), 7),
            "device_resident_s": None if resident is None
            else round(resident, 7),
            "resident_us_per_graph": None if resident is None
            else round(resident / B * 1e6, 3),
            "host_native_drain_s": round(_median(host_times), 7),
            "host_us_per_graph": round(_median(host_times) / B * 1e6, 3),
            "host_graph_build_s": round(build_s, 6),
            "paths_per_graph": round(float(np.mean(npaths_host)), 2),
            "paths_agree": bool(np.array_equal(npaths_dev, npaths_host)),
            "bit_exact_vs_host": bool(
                np.array_equal(npaths_dev, npaths_host)
                and np.array_equal(ws_dev[live].view(np.int64),
                                   ws_host[live].view(np.int64))),
            "bytes_up": int(W.nbytes + P.nbytes + sink.nbytes
                            + scal.nbytes),
        })
    fit, break_even = _fit(table, "host_native_drain_s")
    # resident (compute-only) fit a2 + b2*B, over the same rows
    a2 = b2 = None
    tr = [r for r in table if r["device_resident_s"]]
    if tr:
        a2, b2 = _clamped_line(
            np.array([r["B"] for r in tr], dtype=np.float64),
            np.array([r["device_resident_s"] for r in tr]))
    fit["a2_resident_launch_s"] = None if a2 is None else round(a2, 7)
    fit["b2_resident_per_graph_s"] = None if b2 is None else round(b2, 9)
    return {
        "platform": platform_name(dev),
        "card": card_name(dev),
        "V": V,
        "table": table,
        "fit": fit,
        "break_even_B": break_even,
        "note": ("no crossover: per-graph device marginal cost b >= host "
                 "per-graph cost c; the card cannot amortize at ANY batch "
                 "size" if break_even is None else
                 "device wins for waves with >= break_even_B graphs"),
    }


def _synth_scallops(B, seed=5):
    """Random flow-consistent Scallop instances (production-ish sizes)
    with phasing paths and occasional strands — the shared inputs for the
    ladder crossover (host ladder vs device ladder)."""
    import random

    from ..config import Parameters
    from ..core.graph_io import simulate_graph
    from ..scallop.decompose import Scallop
    from ..scallop.hyper_set import HyperSet
    out = []
    s = seed
    while len(out) < B:
        s += 1
        rng = random.Random(s)
        nv = rng.randint(8, 30)
        gr = simulate_graph(nv, rng.randint(nv, 3 * nv), 100, seed=s)
        if gr.num_edges() == 0:
            continue
        for e in gr.edges():
            ei = gr.get_edge_info(e)
            ei.samples = {0}
            ei.spAbd = {0: gr.get_edge_weight(e)}
            ei.abd = gr.get_edge_weight(e)
            ei.count = 1
            if s % 3 == 0:
                ei.strand = rng.choice([0, 0, 0, 1, 2])
        hs = HyperSet()
        n = gr.num_vertices() - 1
        for _ in range(rng.randint(0, 8)):
            v, path = 0, []
            while v != n:
                outs = gr.out_edges(v)
                if not outs:
                    break
                e = rng.choice(outs)
                v = e.t
                if v != n:
                    path.append(v)
            if len(path) >= 2:
                hs.add_node_list(path, rng.randint(2, 10))
        hs.filter_nodes(gr)
        out.append(Scallop(gr, hs, Parameters()))
    return out


def measure_ladder(batches=(8, 64), reps=3, seed=5, V=None, E=None,
                   H=None, L=None, DMAX=None, DLOG=None, device=None):
    """Ladder crossover sweep: the device solver's dispatch (whole-batch
    resolution-arm prefix, ops/ladder_device.py over ops/ladder_kernel.py)
    vs the genuine native host ladder (core_bench_ladder) on identical
    graphs.  Same fit and break-even shape as measure().  The batch sizes
    are powers of two, the sizes the solver ships; the shape kwargs size
    the solver (default: the production shape)."""
    from ..meta import native_core
    from . import ladder_kernel as lk
    from . import ladder_ref
    from .ladder_device import DeviceLadder

    if not native_core.bench_ladder_available():
        return {"error": "native core_bench_ladder unavailable"}
    dev = port_device() if device is None else torch.device(device)
    kV = V or lk.DEFAULT_V
    kE = E or lk.DEFAULT_E
    kH = H or lk.DEFAULT_H
    kL = L or lk.DEFAULT_L
    kD = DMAX or lk.DEFAULT_DMAX
    kG = DLOG or lk.DEFAULT_DLOG
    table = []
    for B in sorted(set(int(b) for b in batches)):
        scs = _synth_scallops(B, seed=seed)
        # flatten for the native bench
        nv, eoff, es, et, ew, estr = [], [0], [], [], [], []
        hoff, hvoff, hverts, hcnts = [0], [0], [], []
        for sc in scs:
            gr = sc.gr
            nv.append(gr.num_vertices())
            for e in sc.i2e:
                es.append(e.s)
                et.append(e.t)
                ew.append(gr.get_edge_weight(e))
                estr.append(gr.get_edge_info(e).strand)
            eoff.append(len(es))
            for vvl, c in sc.hs.nodes.items():
                hverts.extend(vvl)
                hvoff.append(len(hverts))
                hcnts.append(c)
            hoff.append(len(hvoff) - 1)
        host_times = []
        ndec_host = None
        build_s = 0.0
        for _ in range(reps):
            ndec_host, build_s, lad_s = native_core.bench_ladder(
                nv, eoff, es, et, ew, estr, hoff, hvoff, hverts, hcnts,
                scs[0].cfg)
            host_times.append(lad_s)
        # device: stage the identical dense states at the solver's shape
        states = [ladder_ref.export_scallop(sc, emax=kE, hmax=kH,
                                            lmax=kL) for sc in scs]
        states = [st if st is not None and st.nv <= kV else None
                  for st in states]
        elig = np.array([st is not None for st in states])
        ld = DeviceLadder(batch=B, maxv=kV, maxe=kE, maxh=kH, maxl=kL,
                          dmax=kD, dlog=kG, device=dev)
        ld.stage_states(lk.pack_states(states, B, kV, kE, kH, kL), B)
        _, _, ndec_dev, status = ld.solve(B)    # warm: builds the kernels
        it0 = ld.stats["ladder_iterations"]
        dev_times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            ld.solve(B)
            dev_times.append(time.perf_counter() - t0)
        clean = status == 0
        agree = int(np.sum(clean & elig & (ndec_dev == ndec_host)))
        table.append({
            "B": B,
            "device_dispatch_s": round(_median(dev_times), 6),
            "iterations_per_dispatch":
            (ld.stats["ladder_iterations"] - it0) // max(reps, 1),
            "host_native_ladder_s": round(_median(host_times), 7),
            "host_graph_build_s": round(build_s, 6),
            "decisions_per_graph": round(float(np.mean(ndec_host)), 2),
            "eligible": int(elig.sum()),
            "clean": int(clean.sum()),
            "eligible_and_clean": int(np.sum(elig & clean)),
            "ndec_agree": agree,
        })
    fit, be = _fit(table, "host_native_ladder_s")
    return {
        "platform": platform_name(dev),
        "card": card_name(dev),
        "table": table,
        "fit": fit,
        "break_even_B": be,
    }


def _timed_solver_rows(solver, sizes, reps):
    """[{B, device_dispatch_s}] of solver.solve(B), warm, host clock."""
    rows = []
    for B in sizes:
        solver.solve(B)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            solver.solve(B)
            times.append(time.perf_counter() - t0)
        rows.append({"B": B, "device_dispatch_s": round(_median(times), 7)})
    return rows


def measure_bridge(c_host, sizes=(1, 64), reps=3, seed=41, device=None):
    """The bridge top-K solver's dispatch (ops/bridge_topk.py DeviceBridge,
    host clock of solve()) on seeded DAG windows at the production shape.
    The native core has no standalone bench of the pier DP, so the host
    side is c_host, the drain's measured host cost a graph: a pier-DP
    instance is cheaper on the host than a drain, so a dispatch that does
    not beat c_host a instance surely loses."""
    from . import bridge_topk as bt
    dev = port_device() if device is None else torch.device(device)
    bd = bt.DeviceBridge(device=dev)
    for stage, a in zip((bd.P, bd.Wt, bd.Lv, bd.tgt),
                        bt.fuzz_batch(np.random.default_rng(seed), bd.batch)):
        stage[...] = a
    table = _timed_solver_rows(bd, [s for s in sizes if s <= bd.batch], reps)
    fit, be = _fit(table, c=c_host)
    return {"platform": platform_name(dev), "card": card_name(dev),
            "table": table, "fit": fit, "break_even_B": be,
            "full_batch": bd.batch,
            "host_side": "the drain's c (no native bench of the pier DP)"}


def measure_support(c_host, sizes=(1, 64), reps=5, seed=42, device=None):
    """The support reduce's dispatch (ops/support.py DeviceSupport, host
    clock of solve()) on seeded integral weights.  The host side is c_host,
    the drain's measured host cost a graph, for the reason measure_bridge
    gives: a group's support sums cost the host less than a drain."""
    from .support import DeviceSupport
    dev = port_device() if device is None else torch.device(device)
    sd = DeviceSupport(device=dev)
    sd.jw[...] = np.random.default_rng(seed).integers(
        0, 1000, size=sd.jw.shape).astype(np.float32)
    table = _timed_solver_rows(sd, [s for s in sizes if s <= sd.batch], reps)
    fit, be = _fit(table, c=c_host)
    return {"platform": platform_name(dev), "card": card_name(dev),
            "table": table, "fit": fit, "break_even_B": be,
            "full_batch": sd.batch,
            "host_side": "the drain's c (no native bench of the support "
                         "sums)"}


def measure_similarity(sizes=(256, 1024, 4096), n_splices=512,
                       reps=3, seed=9, device=None):
    """Crossover for the one matmul-shaped stage: the pairwise splice-set
    similarity product (ops/similarity.py; bundle_group.cc:190-231's O(n^2)
    sorted intersections as C = A @ A^T).  Measures the dense device form's
    dispatch (copies included) and the host numpy matmul on identical
    incidence matrices at increasing region sizes — the stage whose
    operations grow quadratically while its copies grow linearly; then the
    sparse form against the production host path (sparse_form)."""
    from . import similarity

    dev = port_device() if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    rows = []
    counted = dict(similarity.stats)    # a measurement is not traffic
    for n in sizes:
        inc = (rng.random((n, n_splices)) < 0.02).astype(np.float32)
        want = inc @ inc.T
        got = similarity._intersection_matrix_device(inc, dev)    # warm
        dev_t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            similarity._intersection_matrix_device(inc, dev)
            dev_t.append(time.perf_counter() - t0)
        host = []
        for _ in range(reps):
            t0 = time.perf_counter()
            inc @ inc.T
            host.append(time.perf_counter() - t0)
        gflop = 2.0 * n * n * n_splices / 1e9
        d = _median(dev_t)
        h = _median(host)
        rows.append({
            "n_bundles": n,
            "device_dispatch_s": round(d, 6),
            "host_numpy_s": round(h, 6),
            "gflop": round(gflop, 3),
            "device_gflops": round(gflop / d, 2),
            "host_gflops": round(gflop / h, 2),
            "counts_identical": bool(np.array_equal(got, want)),
            "device_wins": bool(d < h),
        })
    similarity.stats.update(counted)
    sparse = _measure_similarity_sparse(sizes=sizes, reps=reps, seed=seed,
                                        device=dev)
    return {
        "platform": platform_name(dev),
        "card": card_name(dev),
        "n_splices": n_splices,
        "table": rows,
        "sparse_form": sparse,
        "fit": sparse["fit"],
        "break_even_B": sparse["break_even_B"],
        "note": ("the dense table compares the device product with a DENSE "
                 "host matmul.  The PRODUCTION host path is stronger than "
                 "either: the native splice-index intersections only "
                 "compare bundles that share a splice (near-linear on "
                 "sparse overlap).  sparse_form measures the device form "
                 "'auto' would run (COO upload, on-device threshold, "
                 "compact top-K download) against it; the fit is "
                 "sparse_form's"),
    }


def _measure_similarity_sparse(sizes=(256, 1024, 4096), reps=3, seed=9,
                               avg_splices=8, device=None):
    """Sparse device similarity (ops/similarity.py _pairs_device_sparse)
    vs the Python host pairwise path vs the NATIVE sparse splice-index
    clustering (core_cluster_groups) on identical production-shaped splice
    lists.  The fit is a + b*n over the sparse dispatches against c*n of
    the native clustering; one clustering does the pair search of BOTH
    similarity rounds and the unions, so the device side is understated,
    and a fit that loses here loses in production."""
    import random

    from ..config import Parameters
    from ..meta import native_core
    from . import similarity

    dev = port_device() if device is None else torch.device(device)
    rng = random.Random(seed)
    rows = []
    cfg = Parameters()
    min_sim = float(cfg.min_grouping_similarity)
    counted = dict(similarity.stats)    # a measurement is not traffic

    class _B:                        # minimal bundle stub for the native
        __slots__ = ("splices", "_splices_arr")    # clustering rounds

        def __init__(self, s):
            self.splices = s
            self._splices_arr = np.asarray(s, dtype=np.int32)

    for n in sizes:
        npos = max(64, n * 2)        # splice pool grows with the region
        lists = []
        for _ in range(n):
            k = rng.randint(max(2, avg_splices - 4), avg_splices + 6)
            lists.append(sorted(rng.sample(range(npos), k)))
        nnz = sum(len(s) for s in lists)
        # device sparse form (warm once, then timed)
        res_dev = None
        t_dev = []
        for _ in range(reps + 1):
            t0 = time.perf_counter()
            sizes_a = np.array([len(s) for s in lists], dtype=np.int64)
            allp = sorted({p for s in lists for p in s})
            pidx = {p: i for i, p in enumerate(allp)}
            res_dev = similarity._pairs_device_sparse(
                lists, sizes_a, pidx, len(allp), min_sim, dev)
            t_dev.append(time.perf_counter() - t0)
        dev_s = _median(t_dev[1:]) if res_dev is not None else None
        # host pairwise (dense numpy path)
        th = similarity._DEVICE_THRESHOLD
        similarity._DEVICE_THRESHOLD = 10 ** 9
        try:
            t_host = []
            res_host = None
            for _ in range(reps):
                t0 = time.perf_counter()
                res_host = similarity.pairwise_splice_similarity(
                    lists, min_sim)
                t_host.append(time.perf_counter() - t0)
        finally:
            similarity._DEVICE_THRESHOLD = th
        # native sparse splice-index clustering (end-to-end rounds)
        t_nat = []
        gset = [_B(s) for s in lists]
        for _ in range(reps):
            t0 = time.perf_counter()
            native_core.cluster_groups_native(gset, cfg)
            t_nat.append(time.perf_counter() - t0)
        nat = _median(t_nat)
        rows.append({
            "n_bundles": n,
            "nnz": nnz,
            "device_dispatch_s": None if dev_s is None else round(dev_s, 6),
            "host_pairwise_s": round(_median(t_host), 6),
            "native_sparse_cluster_s": round(nat, 7),
            "results_identical": (res_dev == res_host)
            if res_dev is not None else None,
            "bytes_up_sparse": nnz * 16,
            "bytes_up_dense": n * len(allp) * 4,
            "sparse_device_vs_native": None if dev_s is None or nat <= 0
            else round(dev_s / nat, 2),
        })
    similarity.stats.update(counted)
    wins = [r for r in rows if r["sparse_device_vs_native"] is not None
            and r["sparse_device_vs_native"] < 1.0]
    fitted = [r for r in rows if r["device_dispatch_s"] is not None]
    fit, be = _fit(fitted, "native_sparse_cluster_s", size_key="n_bundles") \
        if fitted else (None, None)
    return {
        "rows": rows,
        "fit": fit,
        "break_even_B": be,
        "sparse_device_beats_native_host": bool(wins),
        "note": ("the sparse device form undercuts the native host "
                 "clustering at some measured size" if wins else
                 "the native splice-index host clustering (work ~ sum of "
                 "per-splice subset sizes) stays below the sparse device "
                 "form at every measured region size: 'auto' keeps "
                 "clustering on the host"),
    }


def measure_coverage(batches=(256, 4096, 65536), S=16, reps=5, seed=11,
                     device=None):
    """A measured crossover row for the region-stats form (ops/coverage.py,
    the vectorized evaluate_rectangle of rnacore/interval_map.cc:166-195).
    Times the device dispatch (numpy in, device compute, numpy out) vs the
    host numpy form on identical padded segment batches, in f64; per-region
    host work is O(S) adds — the bandwidth-bound, tiny-arithmetic end of
    the pipeline.  No stage of the CLI dispatches it alone: it runs inside
    the wave step (parallel/mesh.py)."""
    from .coverage import batch_from_numpy, region_stats, region_stats_host

    dev = port_device() if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    rows = []

    def dispatch(vals, lens, mask, span):
        out = region_stats(*batch_from_numpy(vals, lens, mask, span, dev))
        return [t.cpu().numpy() for t in out]

    for R in sorted(set(int(b) for b in batches)):
        vals = rng.integers(1, 500, size=(R, S)).astype(np.float64)
        lens = rng.integers(1, 300, size=(R, S)).astype(np.float64)
        mask = (rng.random((R, S)) < 0.7).astype(np.float64)
        span = (lens * mask).sum(axis=1) + rng.integers(0, 100, R)
        got = dispatch(vals, lens, mask, span)      # warm
        dev_t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            dispatch(vals, lens, mask, span)
            dev_t.append(time.perf_counter() - t0)
        host = []
        want = None
        for _ in range(reps):
            t0 = time.perf_counter()
            want = region_stats_host(vals, lens, mask, span)
            host.append(time.perf_counter() - t0)
        d = _median(dev_t)
        h = _median(host)
        rows.append({
            "n_regions": R,
            "device_dispatch_s": round(d, 7),
            "host_numpy_s": round(h, 7),
            "bytes_up": int(vals.nbytes + lens.nbytes + mask.nbytes
                            + span.nbytes),
            "mx_identical": bool(np.array_equal(got[2], want[2])),
            "ave_dev_within_1e-6": bool(
                np.allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
                and np.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)),
            "device_wins": bool(d < h),
        })
    wins = [r for r in rows if r["device_wins"]]
    return {
        "platform": platform_name(dev),
        "card": card_name(dev),
        "segments_per_region": S,
        "table": rows,
        "device_ever_wins": bool(wins),
        "note": ("region-stats is O(S) adds per region on KB-scale rows — "
                 + ("the device dispatch undercuts host numpy from n=%d"
                    % wins[0]["n_regions"] if wins else
                    "host numpy wins at every measured batch size")),
    }


def measure_policy(drain_batches=(16, 64, 256), ladder_batches=(8, 64),
                   similarity_sizes=(256, 1024), reps=3, device=None):
    """Measure every stage 'auto' decides about, on the port's device.
    Returns the drain's calibration (measure()) with the other stages'
    under "stages" and the seconds the whole measurement took."""
    dev = port_device() if device is None else torch.device(device)
    t0 = time.perf_counter()
    cal = measure(batches=drain_batches, reps=reps, device=dev)
    c = cal["fit"]["c_per_graph_host_s"]
    sim = _measure_similarity_sparse(sizes=similarity_sizes, reps=reps,
                                     device=dev)
    cal["stages"] = {
        "bridge": measure_bridge(c, reps=reps, device=dev),
        "support": measure_support(c, reps=reps, device=dev),
        "ladder": measure_ladder(batches=ladder_batches, reps=reps,
                                 device=dev),
        "similarity": {"table": sim["rows"], "fit": sim["fit"],
                       "break_even_B": sim["break_even_B"]},
    }
    cal["measured_in_s"] = round(time.perf_counter() - t0, 3)
    return cal


def stage_calibration(cal, stage):
    """The part of a calibration that holds `stage`'s fit: the top level
    for the drain, cal["stages"][stage] otherwise; None when absent."""
    if not cal:
        return None
    sub = cal if stage == "drain" else cal.get("stages", {}).get(stage)
    return sub if sub and sub.get("fit") else None


def cache_path():
    """The calibration's file for the port's device: in the temporary
    directory (TMPDIR, else /tmp), named after the platform and the card,
    so that no other package's or card's file is ever read.  Delete it to
    have the next 'auto' run measure again."""
    card = re.sub(r"[^A-Za-z0-9]+", "-", card_name()).strip("-")
    return os.path.join(tempfile.gettempdir(), CACHE_FMT.format(
        platform=platform_name(), card=card))


def calibration(measure_if_missing=False):
    """Load the cached calibration of the present platform and card;
    optionally measure (and cache) when absent or written for another
    card.  Returns None when unavailable, and on the CPU device, where
    nothing is read or measured: the "device" is this host, and a dispatch
    only adds overhead to the native host path."""
    if platform_name() == "cpu":
        return None
    path = cache_path()
    try:
        with open(path) as fh:
            cal = json.load(fh)
        if cal.get("platform") == platform_name() \
                and cal.get("card") == card_name() and "fit" in cal:
            return cal
    except (OSError, ValueError):
        pass
    if not measure_if_missing:
        return None
    cal = measure_policy()
    save(cal)
    return cal


def save(cal):
    """Write the calibration to cache_path() (atomically; an unwritable
    directory only means the next run measures again)."""
    path = cache_path()
    tmp = path + ".tmp.%d" % os.getpid()
    try:
        with open(tmp, "w") as fh:
            json.dump(cal, fh)
        os.replace(tmp, path)
    except OSError:
        pass
    return path


def device_wins(n_graphs, cal):
    """The amortization decision: a + b*n < c*n for this wave."""
    if not cal:
        return False
    f = cal["fit"]
    a = f["a_fixed_dispatch_s"]
    b = f["b_per_graph_device_s"]
    c = f["c_per_graph_host_s"]
    return a + b * n_graphs < c * n_graphs


def _row_wins(n, cal):
    """Whether the device won in the measured row whose size is nearest to
    n (by ratio): its dispatch against the fit's c times its size.  A line
    through rows that grow faster than a line (a product's n^2) can come
    out with a = 0 and promise wins at sizes where the dispatch's fixed
    cost loses; the nearest row itself cannot."""
    rows = [r for r in cal.get("table", [])
            if r.get("device_dispatch_s") is not None]
    if not rows:
        return False
    size = (lambda r: r["B"] if "B" in r else r["n_bundles"])
    row = min(rows, key=lambda r: abs(np.log(size(r) / max(n, 1))))
    return row["device_dispatch_s"] \
        < cal["fit"]["c_per_graph_host_s"] * size(row)


def stage_wins(stage, n, cal):
    """Whether 'auto' engages `stage` for n instances under calibration
    `cal`: the stage's own fit must win at n, and so must its measured row
    nearest to n.  The bridge, the support reduce and the ladder run inside
    a device wave, whose drains then run on the card too, so for them the
    drain must win at n as well.  A stage without a fit stays on the
    host."""
    def wins(name):
        sub = stage_calibration(cal, name)
        return device_wins(n, sub) and _row_wins(n, sub)

    if stage in ("drain", "similarity"):
        return wins(stage)
    return wins(stage) and wins("drain")
