"""The plain reference of the drain stage: the whole repeat-until-drained
greedy decomposition of each graph of a [B, V, V] batch in topological
order, in numpy float64, written from the semantics that the port's
drain kernel (csrc/drain.cu) and its plain version share
(splice_graph.cc:819-858 for the bottleneck path and its backtrace,
scallop.cc:2433-2484 for the split), with nothing of the port imported.

Inputs: W [B,V,V] f64 (NEG where absent), P [B,V,V] int (in-edge list
positions, -1 where absent), sink [B] int (topological position of the
sink, 0 = inactive row), scal [B,3] f64 = {mincov, guard, smin}.
Outputs: paths [B,maxp,V] u8, ws [B,maxp] f64, npaths [B] i32.
"""

from __future__ import annotations

import numpy as np

NEG = -1.0e18       # absent edge / unreachable vertex
POS = 1.0e18        # the source's own bottleneck


def drain(W, P, sink, scal, maxp):
    W = np.array(W, dtype=np.float64)
    B, V, _ = W.shape
    Pl = np.asarray(P, dtype=np.int64)
    sinkl = np.asarray(sink, dtype=np.int64)
    scal = np.asarray(scal, dtype=np.float64)
    mincov = scal[:, 0]
    guard = scal[:, 1][:, None, None]
    smin = scal[:, 2][:, None, None]
    bidx = np.arange(B)
    paths = np.zeros((B, maxp, V), dtype=np.uint8)
    ws = np.zeros((B, maxp), dtype=np.float64)
    npaths = np.zeros(B, dtype=np.int32)
    act = sinkl > 0
    for it in range(maxp):
        if not act.any():
            break
        # forward bottleneck DP: the best path's smallest edge to each v
        T = np.full((B, V), NEG)
        T[:, 0] = POS
        for v in range(1, V):
            T[:, v] = np.minimum(T, W[:, :, v]).max(axis=1)
        wsink = T[bidx, sinkl]
        ok = act & (wsink >= 0) & (wsink > mincov)
        # backtrace from the sink: among valid candidates equal to the
        # best, the parent is the one of the largest in-edge position
        x = np.where(ok, sinkl, 0)
        pm = np.zeros((B, V), dtype=bool)
        pm[:, 0] = ok
        emask = np.zeros((B, V, V), dtype=bool)
        for _ in range(V):
            walking = ok & (x != 0)
            if not walking.any():
                break
            pm[bidx, x] |= walking
            Wcol = W[bidx, :, x]
            valid = (Wcol >= 0) & (T >= 0)
            cand = np.where(valid, np.minimum(T, Wcol), NEG)
            best = cand.max(axis=1, keepdims=True)
            score = np.where(valid & (cand == best), Pl[bidx, :, x], -1)
            u = score.argmax(axis=1)
            emask[bidx, u, x] |= walking
            x = np.where(walking, u, x)
        # subtract the bottleneck along the path: an edge within smin of
        # it goes, one that would fall under guard keeps guard
        diff = W - wsink[:, None, None]
        rem = np.where(np.abs(diff) <= smin, NEG,
                       np.where(diff <= guard, guard, diff))
        W = np.where(emask, rem, W)
        paths[ok, it] = pm[ok]
        ws[ok, it] = wsink[ok]
        npaths += ok.astype(np.int32)
        act = ok
    return paths, ws, npaths
