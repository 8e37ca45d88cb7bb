"""Dense reference machine for the scallop resolution-ladder prefix.

SURVEY §7 names "Scallop's sequential, data-dependent graph surgery" as
the hard part of the TPU design; this module is the semantic spec for the
device form (ops/ladder_kernel.py): the ladder arms that dominate
production work — resolve_broken_vertex, resolve_trivial_vertex_fast,
resolve_trivial_vertex(1), resolve_smallest_edges (scallop/scallop.cc:
190-236, 1256-1269, 1180-1234, 844-945) — run over a DENSE state
(flat edge table + hyper-edge lists) instead of the host's intrusive
lists, emitting the decision log {(arm, vertex-or-edge)} the host replays
with full metadata.  Measured on production cohorts, 100% of ladder
iterations are these arms; the machine stops CLEAN when they are
exhausted (host then re-checks the router/unsplittable arms, which is
also where it lands in an unmodified run) or OVERFLOW when a capacity cap
is hit (host redoes the whole ladder — byte-identical either way).

Exactness model: identical to the fused drain (ops/greedy_fused.py) —
every arithmetic step (balance sqrt scaling, split/merge weight updates,
min/ratio comparisons, ordered f64 sums in adjacency-list order) is
transcribed operation-for-operation, so on an IEEE-f64 backend the
decisions are bit-identical to the host ladder ("trust mode"); the fuzz
(tests/test_ladder_ref.py) pins this machine against the Python Scallop
arm by arm.

State layout (per graph):
- edge table, capacity E: e_src/e_dst i32 (-1 = free slot), e_wrt f64,
  e_str i8, e_in_stamp/e_out_stamp i32 (adjacency-list iteration order:
  ascending stamp == the host's insertion-ordered vin/vout lists; new
  edges take fresh increasing stamps = list append), e_alive bool;
  n_edges mirrors len(i2e) so new-edge INDEX allocation matches the host
  exactly (sorted-pair processing order depends on it).
- nonzero bool[V] (the host's nonzeroset).
- hyper lists: h_edge [H, L] i32 with h_len[H]; -1 entries are the
  host's broken-link placeholders (kept in place by hs.remove), entries
  beyond h_len do not exist.  Queries (left/right_extend, left/right_
  dominate) and surgery (replace_pair/replace/remove) scan the lists
  directly — equivalent to the host's e2s index because stale e2s
  entries are always filtered by an occurrence scan (hyper_set.cc:
  626-675, 787-818, 949-1082).

Decision-irrelevant metadata (mev/med/mei, samples/spAbd/abd/count,
vertex weights) is NOT simulated: the host replay computes it while
applying the log.
"""

from __future__ import annotations

import math

import numpy as np

BROKEN = 0
TRIVIAL = 1
SMALLEST = 2

ST_CLEAN = 0       # arms exhausted; host continues at the router rungs
ST_OVERFLOW = 1    # capacity hit; host ignores the log and redoes all
ST_INELIGIBLE = 2  # export refused


class LadderState:
    """Dense mutable state; numpy-backed so the JAX kernel can be compared
    field by field."""

    def __init__(self, nv, emax, hmax, lmax):
        self.nv = nv
        self.e_src = np.full(emax, -1, np.int32)
        self.e_dst = np.full(emax, -1, np.int32)
        self.e_wrt = np.zeros(emax, np.float64)
        self.e_str = np.zeros(emax, np.int8)
        self.e_in_stamp = np.zeros(emax, np.int32)
        self.e_out_stamp = np.zeros(emax, np.int32)
        self.e_alive = np.zeros(emax, bool)
        self.n_edges = 0
        self.next_stamp = 0
        self.nonzero = np.zeros(nv, bool)
        self.h_edge = np.full((hmax, lmax), -1, np.int32)
        self.h_len = np.zeros(hmax, np.int32)
        self.n_hyper = 0
        # cfg
        self.jump_ratio = 0.0       # max_decompose_error_ratio[TRIVIAL_VERTEX]
        self.small_ratio = 0.0      # max_decompose_error_ratio[SMALLEST_EDGE]
        self.guard = 0.0            # min_guaranteed_edge_weight
        self.smin = 0.0


def export_scallop(sc, emax=256, hmax=64, lmax=32):
    """Dense-export a Python Scallop (post-init, pre-ladder).  Returns a
    LadderState or None when ineligible (caps exceeded, non-finite or
    negative weights)."""
    from ..constants import SMALLEST_EDGE, SMIN, TRIVIAL_VERTEX
    gr = sc.gr
    nv = gr.num_vertices()
    ne = len(sc.i2e)
    if ne > emax // 2:          # room for split/merge allocations
        return None
    if len(sc.hs.edges) > hmax:
        return None
    if any(len(v) > lmax for v in sc.hs.edges):
        return None
    st = LadderState(nv, emax, hmax, lmax)
    stamp = 0
    # stamps follow actual adjacency-list positions (insertion order)
    in_stamp = {}
    out_stamp = {}
    for v in range(nv):
        for e in gr.in_edges(v):
            in_stamp[e] = stamp
            stamp += 1
        for e in gr.out_edges(v):
            out_stamp[e] = stamp
            stamp += 1
    for i, ee in enumerate(sc.i2e):
        if ee is None:
            continue
        w = gr.get_edge_weight(ee)
        if not (0.0 <= w < 1e17) or not math.isfinite(w):
            return None
        st.e_src[i] = ee.s
        st.e_dst[i] = ee.t
        st.e_wrt[i] = w
        st.e_str[i] = gr.get_edge_info(ee).strand
        st.e_in_stamp[i] = in_stamp[ee]
        st.e_out_stamp[i] = out_stamp[ee]
        st.e_alive[i] = True
    st.n_edges = ne
    st.next_stamp = stamp
    for i in range(1, nv - 1):
        st.nonzero[i] = i in sc.nonzeroset
    for k, vv in enumerate(sc.hs.edges):
        st.h_len[k] = len(vv)
        st.h_edge[k, :len(vv)] = vv
    st.n_hyper = len(sc.hs.edges)
    r = sc.cfg.max_decompose_error_ratio
    st.jump_ratio = float(r[TRIVIAL_VERTEX])
    st.small_ratio = float(r[SMALLEST_EDGE])
    st.guard = float(sc.cfg.min_guaranteed_edge_weight)
    st.smin = float(SMIN)
    return st


# ------------------------------------------------------- list-order helpers

def _in_list(st, v):
    """Edge ids entering v in adjacency-list (stamp) order."""
    ids = [e for e in range(st.n_edges)
           if st.e_alive[e] and st.e_dst[e] == v]
    ids.sort(key=lambda e: st.e_in_stamp[e])
    return ids


def _out_list(st, v):
    ids = [e for e in range(st.n_edges)
           if st.e_alive[e] and st.e_src[e] == v]
    ids.sort(key=lambda e: st.e_out_stamp[e])
    return ids


def _in_degree(st, v):
    return int(np.sum(st.e_alive[:st.n_edges]
                      & (st.e_dst[:st.n_edges] == v)))


def _out_degree(st, v):
    return int(np.sum(st.e_alive[:st.n_edges]
                      & (st.e_src[:st.n_edges] == v)))


def _strand_degree(st, v):
    """graph.py get_strand_degree: [in0,in1,in2, out0,out1,out2]."""
    vs = [0] * 6
    for e in _in_list(st, v):
        vs[st.e_str[e]] += 1
    for e in _out_list(st, v):
        vs[3 + st.e_str[e]] += 1
    return vs


def _mixed_strand(st, v):
    vs = _strand_degree(st, v)
    return (vs[1] + vs[4]) >= 1 and (vs[2] + vs[5]) >= 1


# ----------------------------------------------------------- hyper queries

def _occurs(st, e):
    """(k, i) occurrences of edge e across hyper lists."""
    out = []
    for k in range(st.n_hyper):
        ln = st.h_len[k]
        row = st.h_edge[k]
        for i in range(ln):
            if row[i] == e:
                out.append((k, i))
    return out


def _left_extend(st, e):
    """hyper_set.cc:949-965"""
    for k, i in _occurs(st, e):
        if i >= 1 and st.h_edge[k, i - 1] != -1:
            return True
    return False


def _right_extend(st, e):
    for k, i in _occurs(st, e):
        if i + 1 < st.h_len[k] and st.h_edge[k, i + 1] != -1:
            return True
    return False


def _left_dominate(st, e):
    """hyper_set.cc:1003-1042: every right-continuation that STARTS at e
    (no left context) must also appear among continuations with left
    context."""
    x1, x2 = set(), set()
    for k, i in _occurs(st, e):
        row, ln = st.h_edge[k], st.h_len[k]
        if i + 1 >= ln or row[i + 1] == -1:
            continue
        if i == 0 or row[i - 1] == -1:
            if i + 2 < ln:
                x1.add((int(row[i + 1]), int(row[i + 2])))
            else:
                x1.add((int(row[i + 1]), -1))
        else:
            x2.add((int(row[i + 1]), -1))
            if i + 2 < ln:
                x2.add((int(row[i + 1]), int(row[i + 2])))
    return x1 <= x2


def _right_dominate(st, e):
    """hyper_set.cc:1044-1082"""
    x1, x2 = set(), set()
    for k, i in _occurs(st, e):
        row, ln = st.h_edge[k], st.h_len[k]
        if i < 1 or row[i - 1] == -1:
            continue
        if i == ln - 1 or row[i + 1] == -1:
            if i - 2 >= 0:
                x1.add((int(row[i - 1]), int(row[i - 2])))
            else:
                x1.add((int(row[i - 1]), -1))
        else:
            x2.add((int(row[i - 1]), -1))
            if i - 2 >= 0:
                x2.add((int(row[i - 1]), int(row[i - 2])))
    return x1 <= x2


# ----------------------------------------------------------- hyper surgery

def _hs_remove(st, e):
    """hyper_set.cc:787-818: occurrences become -1 placeholders."""
    for k, i in _occurs(st, e):
        st.h_edge[k, i] = -1


def _hs_replace_list(st, v, e):
    """hyper_set.cc:626-675 for v of length 1 or 2: consecutive matches of
    v become [e] (the tail erased, the list shrinking)."""
    for k in range(st.n_hyper):
        ln = int(st.h_len[k])
        row = st.h_edge[k]
        # all of v must occur somewhere in the list (get_intersection)
        if not all(any(row[i] == x for i in range(ln)) for x in v):
            continue
        starts = [i for i in range(ln - len(v) + 1)
                  if all(row[i + j] == v[j] for j in range(len(v)))]
        if not starts:
            continue
        for b in sorted(starts, reverse=True):
            row[b] = e
            # erase b+1 .. b+len(v)-1
            tail = len(v) - 1
            if tail:
                row[b + 1:ln - tail] = row[b + 1 + tail:ln].copy()
                ln -= tail
        st.h_len[k] = ln
        row[ln:] = -1


# ------------------------------------------------------------ edge surgery

def _add_edge(st, s, t):
    n = st.n_edges
    if n >= len(st.e_src):
        return -1
    st.e_src[n] = s
    st.e_dst[n] = t
    st.e_alive[n] = True
    st.e_str[n] = 0
    st.e_in_stamp[n] = st.next_stamp
    st.e_out_stamp[n] = st.next_stamp
    st.next_stamp += 1
    st.n_edges = n + 1
    return n


def _split_edge(st, ei, w):
    """scallop.cc:2433-2484 (weight flow only)."""
    ww = float(st.e_wrt[ei])
    if abs(ww - w) <= st.smin:
        return ei
    n = _add_edge(st, int(st.e_src[ei]), int(st.e_dst[ei]))
    if n < 0:
        return -2                 # overflow
    www = ww - w
    if www <= st.guard:
        www = st.guard
    st.e_wrt[ei] = www
    st.e_wrt[n] = w
    st.e_str[n] = st.e_str[ei]    # info copy
    return n


def _merge_adjacent_equal_edges(st, x, y):
    """scallop.cc:2242-2378 (decision-relevant flow only)."""
    xs, xt = int(st.e_src[x]), int(st.e_dst[x])
    ys, yt = int(st.e_src[y]), int(st.e_dst[y])
    if xt != ys and yt != xs:
        return -1
    if yt == xs:
        return _merge_adjacent_equal_edges(st, y, x)
    n = _add_edge(st, xs, yt)
    if n < 0:
        return -2
    wx0 = float(st.e_wrt[x])
    wy0 = float(st.e_wrt[y])
    st.e_wrt[n] = wx0 * 0.5 + wy0 * 0.5
    # borrow_edge_strand(n, x) then (n, y)
    if st.e_str[x] != 0:
        st.e_str[n] = st.e_str[x]
    if st.e_str[y] != 0:
        st.e_str[n] = st.e_str[y]
    st.e_alive[x] = False
    st.e_alive[y] = False
    if _in_degree(st, xt) == 0 and _out_degree(st, xt) == 0:
        st.nonzero[xt] = False
    return n


def _merge_adjacent_edges_w(st, x, y, ww):
    """scallop.cc:2394-2416"""
    if int(st.e_dst[x]) != int(st.e_src[y]):
        x, y = y, x
    x1 = _split_edge(st, x, ww)
    if x1 == -2:
        return -2
    y1 = _split_edge(st, y, ww)
    if y1 == -2:
        return -2
    return _merge_adjacent_equal_edges(st, x1, y1)


def _balance_vertex(st, v):
    """scallop.cc:2486-2576; f64 sums in adjacency-list order."""
    ins = _in_list(st, v)
    outs = _out_list(st, v)
    if not ins or not outs:
        return
    w1 = 0.0
    for e in ins:
        w1 += float(st.e_wrt[e])
    w2 = 0.0
    for e in outs:
        w2 += float(st.e_wrt[e])
    ww = math.sqrt(w1 * w2)
    r1 = ww / w1
    r2 = ww / w2
    m1 = m2 = 0.0
    for e in ins:
        wy = float(st.e_wrt[e]) * r1
        if wy < st.guard:
            m1 += st.guard - wy
            wy = st.guard
        st.e_wrt[e] = wy
    for e in outs:
        wy = float(st.e_wrt[e]) * r2
        if wy < st.guard:
            m2 += st.guard - wy
            wy = st.guard
        st.e_wrt[e] = wy
    if m1 > m2:
        st.e_wrt[outs[0]] = float(st.e_wrt[outs[0]]) + m1 - m2
    elif m1 < m2:
        st.e_wrt[ins[0]] = float(st.e_wrt[ins[0]]) + m2 - m1


def _decompose_trivial_vertex(st, x):
    """scallop.cc:2144-2167 + decompose_vertex_replace :2009-2142 (the
    trivial case covers every hyper route, so the remove_pair branch never
    fires).  Returns False on capacity overflow."""
    _balance_vertex(st, x)
    ins = _in_list(st, x)
    outs = _out_list(st, x)
    pairs = []                  # insertion order (vin x vout)
    for e1 in ins:
        w1 = float(st.e_wrt[e1])
        for e2 in outs:
            w2 = float(st.e_wrt[e2])
            pairs.append((e1, e2, min(w1, w2)))
    # md: accumulated in insertion order; assignment order irrelevant
    md = {}
    for e1, e2, w in pairs:
        md[e1] = md.get(e1, 0.0) + w
        md[e2] = md.get(e2, 0.0) + w
    for e, w in md.items():
        st.e_wrt[e] = w
    m = {}
    for e1, e2, _ in pairs:
        m[e1] = m.get(e1, 0) + 1
        m[e2] = m.get(e2, 0) + 1
    pw = {(e1, e2): w for e1, e2, w in pairs}
    for (e1, e2) in sorted(pw.keys()):
        w = pw[(e1, e2)]
        e = _merge_adjacent_edges_w(st, e1, e2, w)
        if e == -2:
            return False
        _hs_replace_list(st, [e1, e2], e)
        if m[e1] == 1:
            _hs_replace_list(st, [e1], e)
        if m[e2] == 1:
            _hs_replace_list(st, [e2], e)
    for (e1, e2) in sorted(pw.keys()):
        _hs_remove(st, e1)
        _hs_remove(st, e2)
    st.nonzero[x] = False
    return True


# ------------------------------------------------------------- arm logic

def _classify_trivial(st, x, fast):
    """scallop.cc:2169-2196"""
    d1 = _in_degree(st, x)
    d2 = _out_degree(st, x)
    if d1 != 1 and d2 != 1:
        return -1
    e1 = _in_list(st, x)[0]
    e2 = _out_list(st, x)[0]
    if d1 == 1:
        s = int(st.e_src[e1])
        if _out_degree(st, s) == 1:
            return 1
        if fast and _right_dominate(st, e1):
            return 1
    if d2 == 1:
        t = int(st.e_dst[e2])
        if _in_degree(st, t) == 1:
            return 1
        if fast and _left_dominate(st, e2):
            return 1
    return 2


def _balance_ratio(st, v):
    """scallop.cc:2578-2602; ordered sums."""
    w1 = 0.0
    for e in _in_list(st, v):
        w1 += float(st.e_wrt[e])
    w2 = 0.0
    for e in _out_list(st, v):
        w2 += float(st.e_wrt[e])
    return w1 / w2 if w1 >= w2 else w2 / w1


def _smallest_side(st, ids):
    """scallop.cc:2967-3007: ordered sum + last-min-wins scan."""
    e = -1
    s1 = 0.0
    minw = math.inf
    for ei in ids:
        w = float(st.e_wrt[ei])
        s1 += w
        if w > minw:
            continue
        minw = w
        e = ei
    if e == -1:
        return -1, 0.0
    return e, minw / s1


def _compute_smallest_edge(st, x):
    e1, r1 = _smallest_side(st, _in_list(st, x))
    e2, r2 = _smallest_side(st, _out_list(st, x))
    if e1 < 0 or e2 < 0:
        return -1, 0.0
    if r1 < r2:
        return e1, r1
    return e2, r2


def run_ladder(st, max_decisions=256):
    """Run the restricted ladder to exhaustion.  Returns
    (decisions [(arm, target)], status)."""
    decisions = []

    def log(arm, tgt):
        decisions.append((arm, tgt))
        return len(decisions) <= max_decisions

    while True:
        # ---- resolve_broken_vertex (scallop.cc:190-236)
        x = -1
        for i in range(1, st.nv - 1):
            if not st.nonzero[i]:
                continue
            if _in_degree(st, i) >= 1 and _out_degree(st, i) >= 1:
                continue
            x = i
            break
        if x != -1:
            for e in _in_list(st, x) + _out_list(st, x):
                st.e_alive[e] = False
                _hs_remove(st, e)
            st.nonzero[x] = False
            if not log(BROKEN, x):
                return decisions, ST_OVERFLOW
            continue

        # ---- resolve_trivial_vertex_fast (scallop.cc:1256-1269)
        fired = False
        for i in range(1, st.nv - 1):
            if not st.nonzero[i]:
                continue
            d1, d2 = _in_degree(st, i), _out_degree(st, i)
            if d1 <= 0 or d2 <= 0:
                continue
            if d1 >= 2 and d2 >= 2:
                continue
            if _mixed_strand(st, i):
                continue
            if _classify_trivial(st, i, False) != 1:
                continue
            if _balance_ratio(st, i) >= st.jump_ratio:
                continue
            if not _decompose_trivial_vertex(st, i):
                return decisions, ST_OVERFLOW
            fired = True
            if not log(TRIVIAL, i):
                return decisions, ST_OVERFLOW
        if fired:
            continue

        # ---- resolve_trivial_vertex(1, fast=True) (scallop.cc:1180-1234)
        root = -1
        ratio = math.inf
        flag = False
        for i in range(1, st.nv - 1):
            if not st.nonzero[i]:
                continue
            d1, d2 = _in_degree(st, i), _out_degree(st, i)
            if d1 <= 0 or d2 <= 0:
                continue
            if _mixed_strand(st, i):
                continue
            if d1 >= 2 and d2 >= 2:
                continue
            if _classify_trivial(st, i, True) != 1:
                continue
            r = _balance_ratio(st, i)
            if r < 1.02:
                if not _decompose_trivial_vertex(st, i):
                    return decisions, ST_OVERFLOW
                flag = True
                if not log(TRIVIAL, i):
                    return decisions, ST_OVERFLOW
                continue
            if ratio < r:
                continue
            root = i
            ratio = r
            if ratio < st.jump_ratio:
                break
        if flag:
            continue
        if root != -1:
            if not _decompose_trivial_vertex(st, root):
                return decisions, ST_OVERFLOW
            if not log(TRIVIAL, root):
                return decisions, ST_OVERFLOW
            continue

        # ---- resolve_smallest_edges (scallop.cc:844-945)
        se = -1
        ratio = st.small_ratio
        flag = False
        for i in range(1, st.nv - 1):
            if not st.nonzero[i]:
                continue
            if _in_degree(st, i) <= 1 or _out_degree(st, i) <= 1:
                continue
            e, r = _compute_smallest_edge(st, i)
            if e == -1:
                continue
            s, t = int(st.e_src[e]), int(st.e_dst[e])
            if _out_degree(st, s) <= 1 or _in_degree(st, t) <= 1:
                continue
            if _right_extend(st, e) and _left_extend(st, e):
                continue
            if t == i and _right_extend(st, e):
                continue
            if s == i and _left_extend(st, e):
                continue
            vs = _strand_degree(st, i)
            z = int(st.e_str[e])
            if s == i and z >= 1 and vs[0] + vs[z] <= 1:
                continue
            if t == i and z >= 1 and vs[3] + vs[z + 3] <= 1:
                continue
            if r < 0.01:
                st.e_alive[e] = False
                _hs_remove(st, e)
                flag = True
                if not log(SMALLEST, e):
                    return decisions, ST_OVERFLOW
                continue
            if ratio < r:
                continue
            ratio = r
            se = e
        if flag:
            continue
        if se != -1:
            st.e_alive[se] = False
            _hs_remove(st, se)
            if not log(SMALLEST, se):
                return decisions, ST_OVERFLOW
            continue

        return decisions, ST_CLEAN
