"""Fused greedy drain on tensors: the Hopper kernel and its plain version.

Counterpart of aletsch_tpu/ops/pallas_drain.py (the TPU kernel) and of the
XLA f64 form in aletsch_tpu/ops/greedy_fused.py::_build.  All three compute
greedy_fused.drain_host: the whole repeat-until-drained greedy
decomposition of each graph of a [B, V, V] topological-order batch.

- drain_cuda: wrapper of csrc/drain.cu (one block per graph stages W and
  P into shared memory, one warp runs the rounds in push form; f64 or f32
  by W's dtype).  CUDA tensors only.
- drain_torch: the same function in plain PyTorch, vectorised over the
  batch like greedy_fused._build; the CPU tests and the card's checks
  compare against it.
- drain: a CPU tensor goes to drain_torch, a CUDA tensor to the kernel.
- launch_events: CUDA events drain_cuda records around its launch alone.

Inputs: W [B,V,V] f64|f32 (NEG where absent), P [B,V,V] i32 (in-edge list
positions, -1 where absent), sink [B] i32 (topological position of the
sink, 0 = inactive row), scal [B,3] W.dtype = {mincov, guard, smin}.
Outputs: paths [B,maxp,V] u8, ws [B,maxp] W.dtype, npaths [B] i32.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

from .constants import NEG, POS

MAXV = 64       # the kernel's lane l owns vertices l and l + 32
_EVENTS = threading.local()     # launch_events' pair, by thread


@contextmanager
def launch_events(start, end):
    """While open, drain_cuda on this thread records the CUDA event start
    just before its kernel's launch and end just after it, on the launch's
    stream: the kernel's device time, as the bridge and ladder solvers
    take theirs."""
    _EVENTS.pair = (start, end)
    try:
        yield
    finally:
        _EVENTS.pair = None


def _check(W, P, sink, scal, maxp):
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError("W must be [B, V, V], got %s" % (tuple(W.shape),))
    B, V, _ = W.shape
    if W.dtype not in (torch.float64, torch.float32):
        raise TypeError("W must be float64 or float32, got %s" % W.dtype)
    want = {"P": (P, (B, V, V), torch.int32),
            "sink": (sink, (B,), torch.int32),
            "scal": (scal, (B, 3), W.dtype)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError("%s must be %s %s, got %s %s" % (
                name, dtype, shape, t.dtype, tuple(t.shape)))
        if t.device != W.device:
            raise ValueError("%s is on %s, W on %s" % (name, t.device,
                                                       W.device))
    if not 1 <= V <= MAXV:
        raise ValueError("V=%d outside [1, %d]" % (V, MAXV))
    if maxp < 1:
        raise ValueError("maxp must be >= 1, got %d" % maxp)
    return B, V


def drain_cuda(W, P, sink, scal, maxp):
    """Launch the Hopper drain kernel on the current stream; no sync.
    The kernel stages P as int16: present edges need 0 <= P < 32768, which
    the native export meets (P < in-degree < V, no parallel edges)."""
    B, V = _check(W, P, sink, scal, maxp)
    if W.device.type != "cuda":
        raise ValueError("drain_cuda takes CUDA tensors, got %s" % W.device)
    for name, t in (("W", W), ("P", P), ("sink", sink), ("scal", scal)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    dev = W.device
    paths = torch.empty((B, maxp, V), dtype=torch.uint8, device=dev)
    ws = torch.empty((B, maxp), dtype=W.dtype, device=dev)
    npaths = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return paths, ws, npaths
    from ._build import load_library
    lib = load_library()
    fn = lib.aletsch_drain_f64 if W.dtype == torch.float64 \
        else lib.aletsch_drain_f32
    pair = getattr(_EVENTS, "pair", None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        args = (W.data_ptr(), P.data_ptr(), sink.data_ptr(),
                scal.data_ptr(), B, V, int(maxp), paths.data_ptr(),
                ws.data_ptr(), npaths.data_ptr(), stream.cuda_stream)
        if pair is not None:
            pair[0].record(stream)
        err = fn(*args)
        if pair is not None:
            pair[1].record(stream)
    if err != 0:
        raise RuntimeError("drain kernel launch failed: cudaError %d" % err)
    drain_cuda.launches += 1
    return paths, ws, npaths


drain_cuda.launches = 0     # kernel launches since the last reset


def drain_torch(W, P, sink, scal, maxp):
    """Plain PyTorch drain on any device; same results as the kernel."""
    B, V = _check(W, P, sink, scal, maxp)
    dev, dt = W.device, W.dtype
    W = W.clone()
    Pl = P.long()
    sinkl = sink.long()
    mincov, guard, smin = (scal[:, i, None, None] for i in range(3))
    neg = torch.tensor(NEG, dtype=dt, device=dev)
    bidx = torch.arange(B, device=dev)
    paths = torch.zeros((B, maxp, V), dtype=torch.uint8, device=dev)
    ws = torch.zeros((B, maxp), dtype=dt, device=dev)
    npaths = torch.zeros((B,), dtype=torch.int32, device=dev)
    act = sink > 0
    for it in range(maxp):
        if not bool(act.any()):
            break
        # forward bottleneck DP (splice_graph.cc:819-843)
        T = torch.full((B, V), NEG, dtype=dt, device=dev)
        T[:, 0] = POS
        for v in range(1, V):
            T[:, v] = torch.minimum(T, W[:, :, v]).amax(dim=1)
        wsink = T[bidx, sinkl]
        ok = act & (wsink >= 0) & (wsink > mincov[:, 0, 0])
        # backtrace: among valid candidates equal to the best, the parent
        # is the largest in-edge position P (splice_graph.cc:845-858)
        x = torch.where(ok, sinkl, 0)
        pm = torch.zeros((B, V), dtype=torch.bool, device=dev)
        pm[:, 0] = ok
        emask = torch.zeros((B, V, V), dtype=torch.bool, device=dev)
        for _ in range(V):
            walking = ok & (x != 0)
            if not bool(walking.any()):
                break
            pm[bidx, x] |= walking
            Wcol = W[bidx, :, x]
            valid = (Wcol >= 0) & (T >= 0)
            cand = torch.where(valid, torch.minimum(T, Wcol), neg)
            best = cand.amax(dim=1, keepdim=True)
            score = torch.where(valid & (cand == best), Pl[bidx, :, x], -1)
            u = score.argmax(dim=1)
            emask[bidx, u, x] |= walking
            x = torch.where(walking, u, x)
        # subtract the bottleneck along the path (split_edge,
        # scallop.cc:2433-2484)
        diff = W - wsink[:, None, None]
        rem = torch.where(diff.abs() <= smin, neg,
                          torch.where(diff <= guard, guard, diff))
        W = torch.where(emask, rem, W)
        paths[ok, it] = pm[ok].to(torch.uint8)
        ws[ok, it] = wsink[ok]
        npaths += ok.to(torch.int32)
        act = ok
    return paths, ws, npaths


def drain(W, P, sink, scal, maxp):
    """The drain on W's device: plain PyTorch for a CPU tensor, the kernel
    for a CUDA tensor (which raises rather than fall back)."""
    if W.device.type == "cpu":
        return drain_torch(W, P, sink, scal, maxp)
    return drain_cuda(W, P, sink, scal, maxp)


def fuzz_batch(rng, B, V, n_vertices=None):
    """Random DAG batch in topological order with the weights the native
    export produces: sqrt-balanced reals, small integers and exact ties
    (the tie rule's hard case).  Each graph has n_vertices vertices, or a
    random count in [4, V] when None.  Returns numpy (W, P, sink, scal).

    It lives in the package, not in the tests, because the on-card check
    (chip_smoke.py), which imports only this port, and the CPU tests draw
    their kernel inputs from the same generator."""
    W = np.full((B, V, V), NEG)
    P = np.full((B, V, V), -1, dtype=np.int32)
    sink = np.zeros(B, dtype=np.int32)
    scal = np.tile(np.array([2.0, 0.01, 1e-8]), (B, 1))
    for b in range(B):
        n = n_vertices or int(rng.integers(4, V + 1))
        cnt = np.zeros(n, dtype=int)
        for j in range(1, n):
            k = int(rng.integers(1, min(j, 4) + 1))
            for u in rng.choice(j, size=k, replace=False):
                if rng.random() < 0.2:
                    w = float(rng.integers(1, 8))
                else:
                    w = float(rng.integers(1, 1000)) * np.sqrt(rng.random())
                W[b, u, j] = w
                P[b, u, j] = cnt[j]
                cnt[j] += 1
        sink[b] = n - 1
    return W, P, sink, scal


def fuzz_ties(rng, B, V):
    """Random DAG batch built to break a wrong tie rule or a wrong sweep
    order.  Weights are small integers, so most candidates of a vertex tie
    and the parent is decided by P alone; about 4 % of the edges are 0.0 or
    -0.0; the in-edge positions P of a vertex are a random permutation, so
    the largest P is neither the first nor the last u; up to 6 in-edges a
    vertex.  Vertex counts spread over [4, V] (sinks below and above 32 at
    V = 64); one row in four has its sink before the last vertex (what
    lies past the sink must not matter), one in eight has every in-edge of
    the sink removed (no path), one in sixteen is inactive (sink 0).
    Returns numpy (W, P, sink, scal) like fuzz_batch, with mincov 0.5."""
    W = np.full((B, V, V), NEG)
    P = np.full((B, V, V), -1, dtype=np.int32)
    sink = np.zeros(B, dtype=np.int32)
    scal = np.tile(np.array([0.5, 0.01, 1e-8]), (B, 1))
    for b in range(B):
        n = int(rng.integers(4, V + 1))
        for j in range(1, n):
            k = int(rng.integers(1, min(j, 6) + 1))
            us = rng.choice(j, size=k, replace=False)
            for u, pos in zip(us, rng.permutation(k)):
                r = rng.random()
                W[b, u, j] = (0.0 if r < 0.02 else -0.0 if r < 0.04
                              else float(rng.integers(1, 5)))
                P[b, u, j] = pos
        sink[b] = n - 1 if b % 4 else int(rng.integers(n // 2, n))
        if b % 8 == 5:
            W[b, :, sink[b]] = NEG
            P[b, :, sink[b]] = -1
        if b % 16 == 9:
            sink[b] = 0
    return W, P, sink, scal


def fuzz_tables(rng, B, V, n_vertices=None, back_edges=False):
    """Random [B, V, V] f32 batch for the single-source bottleneck DP
    (ops/bottleneck.py), in the NEG form the step-mode export writes: the
    DAGs and weights of fuzz_batch cast to f32, with about 5 % of the edges
    set to 0.0 and 5 % to -0.0 (the export lets both through), and in
    about half of the graphs one or two vertices cut off from the source
    (every in-edge dropped), so they and what only they reach are
    unreachable.  Passed as it is, the batch is also a positive-form input:
    NEG, 0.0 and -0.0 all read as absent there.  With back_edges, the
    diagonal and a third of the entries below it carry weights too: no
    edge of a topological order, and the DP must ignore them (T[u] is
    still NEG when v <= u is computed).  Same generator for the CPU tests
    and the on-card check, for the reason fuzz_batch gives."""
    W, _, sink, _ = fuzz_batch(rng, B, V, n_vertices)
    W = W.astype(np.float32)
    present = W > np.float32(NEG)
    r = rng.random(W.shape)
    W[present & (r < 0.05)] = np.float32(0.0)
    W[present & (r >= 0.05) & (r < 0.10)] = np.float32(-0.0)
    for b in range(B):
        if rng.random() < 0.5:
            k = int(rng.integers(1, 3))
            cut = rng.choice(np.arange(1, sink[b] + 1), size=k, replace=False)
            W[b][:, cut] = np.float32(NEG)
    if back_edges:
        low = np.tril(np.ones((V, V), dtype=bool))[None]
        junk = rng.integers(1, 1000, size=W.shape).astype(np.float32)
        W = np.where(low & (rng.random(W.shape) < 0.33), junk, W)
        idx = np.arange(V)
        W[:, idx, idx] = junk[:, idx, idx]
    return W
