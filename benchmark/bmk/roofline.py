"""The card's peaks (peaks.json) and the bytes and operations of each of
the port's kernels, computed from the packed input and output layouts of
the launches' live rows: each input byte read once and each output byte
written once, and the operations these inputs need at the least.  Frozen
here, apart from the program: a later change to the program cannot
change how its kernels are judged.

A launch's least time is the larger of its bytes over the memory rate and
its operations over the rate of the kernel's precision; a kernel's share
of its roofline is the sum of its launches' least times over the sum of
its device records' times in the trace.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .spec import BENCH_DIR, load_json

PEAKS = load_json(os.path.join(BENCH_DIR, "peaks.json"))


def least_time(nbytes, ops, ops_per_s):
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_b = nbytes / PEAKS["hbm_bytes_per_s"]
    t_o = ops / ops_per_s
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bucket(n, cap):
    """The rows a ladder dispatch ships: the smallest power of two >= n,
    at most cap (aletsch_tpu_torch/ops/_replay.py::bucket)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def drain_launch(sink, npaths, V, maxp, w_item=8):
    """(bytes, ops, ops rate) of one drain launch (csrc/drain.cu) over
    live rows with these sinks (topological position of the sink) and
    path counts.  Bytes: of W (w_item bytes) and P (int32) only the
    entries u < v <= sink, s (s + 1) / 2 of a row, the drain can use; sink
    and scal (three of W's type) read, paths [maxp, V] u8, ws [maxp] and
    npaths written in full.  Operations: one forward sweep a recorded
    path plus the one that stops it (at most maxp), a sweep being one min,
    one compare and one select an entry."""
    s = np.asarray(sink, dtype=np.int64)
    n = s.shape[0]
    pairs = (s > 0) * (s * (s + 1) // 2)
    nbytes = int(pairs.sum()) * (w_item + 4) + n * (4 + 3 * w_item) \
        + n * (maxp * V + maxp * w_item + 4)
    sweeps = np.minimum(np.asarray(npaths, dtype=np.int64) + 1, maxp)
    ops = int((sweeps * pairs * 3).sum())
    rate = PEAKS["f64_ops_per_s"] if w_item == 8 else PEAKS["f32_ops_per_s"]
    return nbytes, ops, rate


# a ladder row's fields by what sizes them (aletsch_tpu_torch/ops/
# ladder_device.py::packed_layout): bytes an edge over the seven edge
# fields (esrc, edst, estr, esin, esout int32, ewrt f64, ealive u8), a
# vertex (nz u8), and the fixed part (meta3 three int32, scal four f64)
LADDER_EDGE_BYTES = 5 * 4 + 8 + 1
LADDER_VERTEX_BYTES = 1
LADDER_FIXED_BYTES = 3 * 4 + 4 * 8


def ladder_launch(nedges, nv, hedge_live, hlen_live, shipped, ndec, events):
    """(bytes, ops, ops rate) of one ladder launch (csrc/ladder.cu) over
    live rows: of each row's packed inputs only its nedges edges, nv
    vertices and live hyper-edge entries (>= 0; hedge_live, hlen_live: per
    row counts), the switched-off rows shipped behind them (one int32, nv,
    each); as outputs each row's ndec decisions (larm, ltgt int32) and
    its ndec, status and events; as operations the ordered in- and
    out-sums each event needs at the least, two f64 adds a live edge."""
    nedges = np.asarray(nedges, dtype=np.int64)
    n = nedges.shape[0]
    nbytes = int(nedges.sum()) * LADDER_EDGE_BYTES \
        + int(np.asarray(nv, dtype=np.int64).sum()) * LADDER_VERTEX_BYTES \
        + (int(np.sum(hedge_live)) + int(np.sum(hlen_live))) * 4 \
        + n * LADDER_FIXED_BYTES + (shipped - n) * 4 \
        + int(np.asarray(ndec, dtype=np.int64).sum()) * 2 * 4 + n * 3 * 4
    ops = int((np.asarray(events, dtype=np.int64) * nedges).sum()) * 2
    return nbytes, ops, PEAKS["f64_ops_per_s"]


def bridge_launch(P, tgt, pix, S):
    """(bytes, ops, ops rate) of one bridge launch (csrc/bridge.cu) over
    live rows.  Bytes: of each instance's inputs its live in-edges (P >=
    0: P and Wt, int32), the lengths (Lv) of its vertices up to the last
    with a live in-edge, its live targets (tgt >= 0) read; as outputs the
    stacks of its live targets (ostk [K, S] each) and the parent tables
    (par, pix [K] each) of those vertices written.  Operations: for each
    vertex step with m valid candidates, S compares for each one's insert
    and m - 1 for selecting the best of them, counted from the entries
    the launch wrote (pix >= 0; the source holds one).  P is [n, V, E]
    in-edge sources, tgt [n, T], pix [n, V, K]."""
    P = np.asarray(P)
    n, V, _ = P.shape
    K = pix.shape[2]
    live = (P >= 0) & (P < V)
    has = live.any(axis=2)                                  # [n, V]
    last = np.where(has.any(axis=1),
                    V - 1 - np.argmax(has[:, ::-1], axis=1), 0)
    nvert = int((last + 1).sum())
    ntgt = int((np.asarray(tgt) >= 0).sum())
    nbytes = int(live.sum()) * 8 + nvert * 4 + ntgt * 4 \
        + ntgt * K * S * 4 + nvert * 2 * K * 4
    entries = (np.asarray(pix) >= 0).sum(axis=2)            # [n, V]
    entries[:, 0] = 1
    m = (entries[np.arange(n)[:, None, None], np.clip(P, 0, V - 1)]
         * live).sum(axis=2)[:, 1:].astype(np.int64)
    ops = int((S * m + np.maximum(m - 1, 0)).sum())
    return nbytes, ops, PEAKS["i32_ops_per_s"]


def share(launches, trace, fragment):
    """A kernel's share of its roofline, in %: the sum of its launches'
    least times (launches: [(bytes, ops, rate), ...]) over its device
    records' summed time in the trace (records whose name holds
    fragment), with the bound that holds for most of the least time; None
    where either side is empty."""
    if trace is None or not launches:
        return None
    n, us = trace.kernel_us(fragment)
    if n == 0 or us <= 0:
        return None
    least = {"bytes": 0.0, "operations": 0.0}
    t_bytes = t_ops = 0.0
    for nbytes, ops, rate in launches:
        t, which = least_time(nbytes, ops, rate)
        least[which] += t
        t_bytes += nbytes / PEAKS["hbm_bytes_per_s"]
        t_ops += ops / rate
    total = least["bytes"] + least["operations"]
    print("[bench] roofline %s: %d launches logged, %d in the trace, "
          "%.9f s device; least time %.9f s, of it %.9f s in launches "
          "bound by bytes and %.9f s by operations (all bytes %.9f s, all "
          "operations %.9f s)" % (fragment, len(launches), n, us / 1e6,
                                  total, least["bytes"],
                                  least["operations"], t_bytes, t_ops),
          file=sys.stderr)
    return 100.0 * total / (us / 1e6)
