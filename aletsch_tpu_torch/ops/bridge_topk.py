"""Wave-batched top-K bridging DP with min-edge stacks and backtrace.

Counterpart of aletsch_tpu/ops/bridge_topk.py (DeviceBridge, bridge_dp,
bridge_dp_host), with the same surface for meta/device_wave.py at pause
kind 2.  Device version of the bridging dynamic program
(bridge/bridge_solver.cc:484-568; host paths: bridge/solver.py
_dynamic_programming and native/core_solve.h
BridgeSolver::dynamic_programming).  Each DP instance is one (source-run,
strand) program over the topo-ordered splice graph window [k1, k2]: per
vertex it keeps the best K = bridge_dp_solution_size (10) entries, each
ranked by an ascending S = bridge_dp_stack_size (5) stack of the smallest
edge weights along the path (lexicographic bottleneck comparison, larger
first), tie-broken by shorter accumulated vertex length, then by host
candidate enumeration order.

Bit-exactness with the host DP:

- Edge weights are ints (the host truncates the double weight); stack
  values can never exceed the 999999 sentinel (update_stack only inserts
  values strictly smaller than an existing element), so clamping exported
  weights to 999999 is exact and i32 keys reproduce the host compare.
- Candidates are enumerated (in-edge slot, entry index) with the in-edge
  slots exported in the host's in-edge list order, and the six i32 keys
  (five negated stack values, then the length) are ordered by three
  stable sorts of i64 pairs of them, from the last pair to the first: a
  stable sort leaves equal keys in candidate order, so equal-key survivors
  match the host's stable top-K selection element for element.

Layout per batch row (padded; -1 = absent):

- P   [V, E] i32   predecessor (topo-local) per in-edge slot, host order
- Wt  [V, E] i32   clamped int edge weight for that slot
- Lv  [V]    i32   vertex lengths (rpos - lpos)
- tgt [T]    i32   pier target vertices (topo-local) to read out

Returns stacks at the targets ([n, T, K, S]; entry invalid iff stack[0] < 0)
plus the full parent/entry-index tables ([n, V, K]) for the host backtrace
(bridge_solver.cc:548-568 walks them in microseconds; shipping the tables
is cheaper than shipping every path).

The k-loop is a Python loop of V - 1 steps of small tensor operations, the
plain form.  On a CUDA device DeviceBridge records it once as a CUDA graph
for each batch size (powers of two) and replays it: the same kernels in
the same order, one launch for the host instead of some five thousand.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device as port_device
from ._replay import Replay, bucket
from .meshing import account_out, join_rows, shard_args
from .constants import (BRIDGE_B, BRIDGE_BIG, BRIDGE_E, BRIDGE_K, BRIDGE_S,
                        BRIDGE_SENTINEL, BRIDGE_T, BRIDGE_V)

K = BRIDGE_K                # bridge_dp_solution_size default (config.py)
S = BRIDGE_S                # bridge_dp_stack_size default
BIG = np.int32(BRIDGE_BIG)
SENTINEL = BRIDGE_SENTINEL  # initial stack fill (bridge_solver.cc:489)

DEFAULT_B = BRIDGE_B        # instances per dispatch
DEFAULT_V = BRIDGE_V        # padded window size
DEFAULT_E = BRIDGE_E        # max in-degree (host fallback above)
DEFAULT_T = BRIDGE_T        # max targets per instance


def _lex_order(keys):
    """Stable lexicographic order of the rows of `keys` (a list of [n, N]
    i32 tensors, most significant first; an even number of them): the
    permutation [n, N] that a stable sort by all keys would apply.  Two i32
    keys a, b pack into one i64 as a * 2^32 + (b + 2^31), which keeps
    their lexicographic order for every i32 a and b."""
    perm = None
    for j in range(len(keys) - 2, -1, -2):
        packed = keys[j].to(torch.int64) * (1 << 32) \
            + (keys[j + 1].to(torch.int64) + (1 << 31))
        if perm is None:
            perm = torch.argsort(packed, dim=1, stable=True)
        else:
            order = torch.argsort(torch.gather(packed, 1, perm), dim=1,
                                  stable=True)
            perm = torch.gather(perm, 1, order)
    return perm


def bridge_dp(P, Wt, Lv, tgt):
    """P, Wt [n, V, E], Lv [n, V], tgt [n, T] i32 tensors on one device ->
    (ostk [n, T, K, S], par [n, V, K], pix [n, V, K]) i32 tensors there."""
    n, V, E = P.shape
    dev = P.device
    i32 = torch.int32
    assert (S + 1) % 2 == 0

    stk = torch.full((n, V, K, S), -1, dtype=i32, device=dev)
    stk[:, 0, 0, :] = SENTINEL
    ln = torch.zeros((n, V, K), dtype=i32, device=dev)
    ln[:, 0, 0] = Lv[:, 0]
    par = torch.full((n, V, K), -1, dtype=i32, device=dev)
    pix = torch.full((n, V, K), -1, dtype=i32, device=dev)
    val = torch.zeros((n, V, K), dtype=torch.bool, device=dev)
    val[:, 0, 0] = True

    bi = torch.arange(n, device=dev)[:, None]                    # [n,1]
    pos = torch.arange(S, dtype=i32, device=dev)                  # [S]
    big = torch.full((), int(BIG), dtype=i32, device=dev)
    minus1 = torch.full((), -1, dtype=i32, device=dev)
    zero = torch.full((), 0, dtype=i32, device=dev)

    for k in range(1, V):
        p = P[:, k]                                               # [n,E]
        w = Wt[:, k]
        lk = Lv[:, k:k + 1]                                       # [n,1]
        pm = p >= 0
        pc = torch.where(pm, p, zero).to(torch.int64)
        gs = stk[bi, pc]                                          # [n,E,K,S]
        gl = ln[bi, pc]                                           # [n,E,K]
        gv = val[bi, pc]
        cv = gv & pm[:, :, None]                                  # [n,E,K]

        # insert w into the ascending stack (update_stack): position =
        # count of elements <= w; c >= S leaves the stack unchanged
        wb = w[:, :, None, None]
        c = torch.sum(gs <= wb, dim=-1, keepdim=True)             # [n,E,K,1]
        shifted = torch.cat([gs[..., :1], gs[..., :-1]], dim=-1)
        ns = torch.where(pos < c, gs,
                         torch.where(pos == c, wb, shifted))      # [n,E,K,S]
        nl = gl + lk[:, :, None]                                  # [n,E,K]

        ns = ns.reshape(n, E * K, S)
        nl = nl.reshape(n, E * K)
        cvf = cv.reshape(n, E * K)

        keys = [torch.where(cvf, -ns[:, :, j], big) for j in range(S)]
        keys.append(torch.where(cvf, nl, big))
        # candidate position = e * K + i: the stable tie-break
        top = _lex_order(keys)[:, :K]                             # [n,K]
        nval = torch.gather(cvf, 1, top)
        nstk = torch.where(
            nval[:, :, None],
            torch.gather(ns, 1, top[:, :, None].expand(n, K, S)), minus1)
        nln = torch.where(nval, torch.gather(nl, 1, top), zero)
        se = torch.div(top, K, rounding_mode="floor")             # [n,K]
        pe = torch.gather(p, 1, se)
        npar = torch.where(nval, pe, minus1)
        npix = torch.where(nval, (top - se * K).to(i32), minus1)

        stk[:, k] = nstk
        ln[:, k] = nln
        par[:, k] = npar
        pix[:, k] = npix
        val[:, k] = nval

    tm = tgt >= 0
    tc = torch.where(tm, tgt, zero).to(torch.int64)
    ostk = stk[bi, tc]                                            # [n,T,K,S]
    oval = val[bi, tc] & tm[:, :, None]
    ostk = torch.where(oval[:, :, :, None], ostk, minus1)
    return ostk, par, pix


def batch_from_numpy(P, Wt, Lv, tgt, device):
    """The JAX solver's staging arrays (all i32) as the port's tensors on
    `device`."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(dev) for a in (P, Wt, Lv, tgt))


class DeviceBridge:
    """Pinned-shape batch solver for production wave bridging
    (meta/device_wave.py): one dispatch computes the top-K stack DP for up
    to `batch` pier-DP instances paused across a region wave's groups."""

    def __init__(self, batch=DEFAULT_B, maxv=DEFAULT_V, maxe=DEFAULT_E,
                 maxt=DEFAULT_T, device=None):
        self.batch = batch
        self.maxv = maxv
        self.maxe = maxe
        self.maxt = maxt
        self.device = port_device() if device is None else torch.device(device)
        pin = self.device.type == "cuda"
        i32 = torch.int32
        self._stage = (
            torch.full((batch, maxv, maxe), -1, dtype=i32, pin_memory=pin),
            torch.zeros((batch, maxv, maxe), dtype=i32, pin_memory=pin),
            torch.zeros((batch, maxv), dtype=i32, pin_memory=pin),
            torch.full((batch, maxt), -1, dtype=i32, pin_memory=pin))
        self.P, self.Wt, self.Lv, self.tgt = (t.numpy() for t in self._stage)
        self._replays = {} if self.device.type == "cuda" else None
        # bridge_device_time: host clock of solve() (copies, DP, sync), s
        self.stats = {"bridge_dispatches": 0, "bridge_instances": 0,
                      "bridge_device_time": 0.0}

    def row(self, i):
        """Writable (P, Wt, Lv, tgt) slices for the native export."""
        return self.P[i], self.Wt[i], self.Lv[i], self.tgt[i]

    def solve(self, nrows):
        """(ostk [n,T,K,S], par [n,V,K], pix [n,V,K]) int32, C-contiguous
        host arrays, for the first nrows batch slots."""
        t0 = time.perf_counter()
        # rows behind the live ones ride along in a replay: stale but
        # well-formed
        rows = nrows if self._replays is None else bucket(nrows, self.batch)
        # several devices: the rows split over them (ops/meshing.py)
        shards, split = shard_args([t[:rows] for t in self._stage],
                                   self.stats, self.device)
        parts = [self._dp(dev, args) for dev, args in shards]
        ostk, par, pix = (a[:nrows] for a in join_rows(parts, split))
        account_out((ostk, par, pix), self.stats, self.device)
        self.stats["bridge_device_time"] += time.perf_counter() - t0
        self.stats["bridge_dispatches"] += 1
        self.stats["bridge_instances"] += nrows
        return ostk, par, pix

    def _dp(self, dev, args):
        """The DP on `dev` over staged rows (replayed as a CUDA graph
        recorded there, one a row count); C-contiguous host outputs."""
        if self._replays is None:
            out = bridge_dp(*(a.to(dev, non_blocking=True) for a in args))
        else:
            key = (dev, args[0].shape[0])
            with torch.cuda.device(dev):
                if key not in self._replays:
                    bufs = tuple(a.to(dev) for a in args)
                    self._replays[key] = (bufs, Replay(
                        lambda: bridge_dp(*bufs), bufs))
                bufs, graph = self._replays[key]
                for buf, a in zip(bufs, args):
                    buf.copy_(a, non_blocking=True)
                out = graph.replay()
        return tuple(t.contiguous().cpu().numpy() for t in out)


def fuzz_batch(rng, n, V=DEFAULT_V, E=DEFAULT_E, T=DEFAULT_T, ties=False):
    """n random DP instances (P, Wt, Lv, tgt) as numpy staging arrays:
    topo-ordered DAG windows of 3 to V vertices with up to E in-edges a
    vertex.  ties=True makes the order hard: weights from {0, 1, 2}, one
    length for every vertex, and half of the in-edge slots repeating a
    predecessor already drawn (parallel edges), so that candidates tie on
    every key and only their position separates them."""
    P = np.full((n, V, E), -1, dtype=np.int32)
    Wt = np.zeros((n, V, E), dtype=np.int32)
    Lv = np.zeros((n, V), dtype=np.int32)
    tgt = np.full((n, T), -1, dtype=np.int32)
    for b in range(n):
        nv = int(rng.integers(3, V + 1))
        Lv[b, :nv] = 7 if ties else rng.integers(1, 50, size=nv)
        for k in range(1, nv):
            deg = int(rng.integers(0, min(k, E) + 1))
            preds = rng.choice(k, size=deg, replace=False)
            if ties and deg > 1:
                dup = rng.random(deg) < 0.5
                preds = np.where(dup, preds[0], preds)
            P[b, k, :deg] = preds
            Wt[b, k, :deg] = rng.integers(0, 3, size=deg) if ties else \
                np.minimum(rng.integers(0, 2000000, size=deg), SENTINEL)
        nt = int(rng.integers(1, T + 1))
        tgt[b, :nt] = rng.integers(1, nv, size=nt)
    return P, Wt, Lv, tgt


def bridge_dp_host(P, Wt, Lv, tgt):
    """Numpy oracle with identical semantics (tests pin bridge_dp == this
    == the solver.py DP)."""
    P = np.asarray(P)
    Wt = np.asarray(Wt)
    Lv = np.asarray(Lv)
    tgt = np.asarray(tgt)
    B, V, E = P.shape
    T = tgt.shape[1]
    ostk = np.full((B, T, K, S), -1, dtype=np.int32)
    opar = np.full((B, V, K), -1, dtype=np.int32)
    opix = np.full((B, V, K), -1, dtype=np.int32)
    for b in range(B):
        table = [[] for _ in range(V)]   # entries: (stack list, len, e, i)
        table[0] = [([SENTINEL] * S, int(Lv[b, 0]), -1, -1)]
        for k in range(1, V):
            cands = []
            for e in range(E):
                j = int(P[b, k, e])
                if j < 0:
                    continue
                w = int(Wt[b, k, e])
                for i, ent in enumerate(table[j]):
                    st = ent[0]
                    c = sum(1 for x in st if x <= w)
                    if c >= S:
                        nst = list(st)
                    else:
                        nst = st[:c] + [w] + st[c:S - 1]
                    cands.append((nst, ent[1] + int(Lv[b, k]), j, i))
            cands.sort(key=lambda t: ([-x for x in t[0]], t[1]))
            table[k] = cands[:K]
            for i, ent in enumerate(table[k]):
                opar[b, k, i] = ent[2]
                opix[b, k, i] = ent[3]
        for t in range(T):
            v = int(tgt[b, t])
            if v < 0:
                continue
            for i, ent in enumerate(table[v]):
                ostk[b, t, i, :] = ent[0]
    return ostk, opar, opix
