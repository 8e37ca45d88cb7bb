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

bridge_dp runs the DP on its inputs' device: bridge_plain, a Python loop
of V - 1 steps of small tensor operations, for CPU tensors; bridge_cuda,
one launch of the hand-written kernel csrc/bridge.cu (one warp an
instance, its tables in shared memory), for CUDA tensors, which raises
rather than fall back.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device as port_device
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


def bridge_plain(P, Wt, Lv, tgt):
    """The plain form: P, Wt [n, V, E], Lv [n, V], tgt [n, T] i32 tensors
    on one device -> (ostk [n, T, K, S], par [n, V, K], pix [n, V, K]) i32
    tensors there."""
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


# the kernel's inputs and outputs, all int32: (name, shape letters)
_IN_SPEC = (("P", "nVE"), ("Wt", "nVE"), ("Lv", "nV"), ("tgt", "nT"))
_OUT_SPEC = (("ostk", "nTKS"), ("par", "nVK"), ("pix", "nVK"))


def kernel_args(P, Wt, Lv, tgt, outs=None):
    """Check bridge_plain's inputs for the kernel and allocate its outputs.
    Each input's instance rows may lie at any stride, each row contiguous
    (the solver's views into its packed staging buffer).  `outs`: the
    outputs (ostk, par, pix) to write instead, dense.  Returns (the
    outputs; the C function's arguments but the stream: pointers, the
    shape, the inputs' row strides, the output pointers).  Raises on a
    wrong type, shape, device or layout."""
    args = (P, Wt, Lv, tgt)
    if P.dim() != 3 or tgt.dim() != 2:
        raise ValueError("P must be [n, V, E] and tgt [n, T], got %s and %s"
                         % (tuple(P.shape), tuple(tgt.shape)))
    n, V, E = P.shape
    dims = dict(n=n, V=V, E=E, T=tgt.shape[1], K=K, S=S)
    for (name, letters), t in zip(_IN_SPEC, args):
        shape = tuple(dims[c] for c in letters)
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError("%s must be torch.int32 %s, got %s %s" % (
                name, shape, t.dtype, tuple(t.shape)))
        if t.device != P.device:
            raise ValueError("%s is on %s, P on %s" % (name, t.device,
                                                       P.device))
        if not t[:1].is_contiguous():
            raise ValueError("%s must be contiguous in each instance's row"
                             % name)
    if V < 1 or E < 1:
        raise ValueError("V and E must be >= 1, got %d, %d" % (V, E))
    if outs is None:
        outs = tuple(torch.empty(tuple(dims[c] for c in letters),
                                 dtype=torch.int32, device=P.device)
                     for _, letters in _OUT_SPEC)
    for (name, letters), t in zip(_OUT_SPEC, outs):
        shape = tuple(dims[c] for c in letters)
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != P.device or not t.is_contiguous():
            raise ValueError("output %s must be a contiguous torch.int32 %s "
                             "on %s" % (name, shape, P.device))
    c_args = ([t.data_ptr() for t in args] + [n, V, E, dims["T"]]
              + [t.stride(0) for t in args] + [t.data_ptr() for t in outs])
    return outs, c_args


def launch(c_args, dev, prof=None, stream=None):
    """One launch of the hand-written kernel (csrc/bridge.cu) with
    kernel_args' arguments on `stream` (a torch.cuda.Stream of card `dev`;
    by default its current stream); n = 0 launches nothing and counts
    nothing.  With `prof`, a zeroed int64 tensor on the card, the profiling
    instance, which adds each pass's cycles and the step counts to it and
    is not counted in bridge_cuda.launches.  No synchronisation."""
    if c_args[4] <= 0:
        return
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        if stream is None:
            stream = torch.cuda.current_stream(dev)
        if prof is None:
            err = lib.aletsch_bridge_topk(*c_args, stream.cuda_stream)
        else:
            err = lib.aletsch_bridge_topk_prof(*c_args, prof.data_ptr(),
                                               stream.cuda_stream)
    if err != 0:
        raise RuntimeError("bridge kernel launch failed: cudaError %d" % err)
    if prof is None:
        bridge_cuda.launches += 1


def bridge_cuda(P, Wt, Lv, tgt):
    """bridge_plain's function as one launch of the hand-written kernel
    (csrc/bridge.cu) on the current stream of the inputs' card, one warp
    an instance.  CUDA tensors of bridge_plain's types only, each
    instance's row contiguous."""
    dev = P.device
    if dev.type != "cuda":
        raise ValueError("bridge_cuda takes CUDA tensors, got %s" % dev)
    outs, c_args = kernel_args(P, Wt, Lv, tgt)
    launch(c_args, dev)
    return outs


bridge_cuda.launches = 0    # kernel launches since the last reset

# the profiling instance's passes and counts, in csrc/bridge_machine.cuh's
# order (PROF_*)
PROF_PASSES = ("load", "build", "select", "write", "empty", "out")
PROF_COUNTS = ("steps", "empty_steps", "tail_steps", "candidates")


def bridge_profile(P, Wt, Lv, tgt):
    """One launch of the kernel's profiling instance (never on the main
    path; not counted in bridge_cuda.launches): bridge_cuda's outputs, the
    clock64() cycles of each pass summed over the instances
    ({PROF_PASSES name: cycles}) and the counts ({PROF_COUNTS name: n})."""
    outs, c_args = kernel_args(P, Wt, Lv, tgt)
    prof = torch.zeros(len(PROF_PASSES) + len(PROF_COUNTS),
                       dtype=torch.int64, device=P.device)
    launch(c_args, P.device, prof)
    p = prof.cpu().numpy()
    n = len(PROF_PASSES)
    return (outs, dict(zip(PROF_PASSES, p[:n].tolist())),
            dict(zip(PROF_COUNTS, p[n:].tolist())))


def bridge_dp(P, Wt, Lv, tgt):
    """The DP on its inputs' device: plain PyTorch for CPU tensors, the
    kernel for any other (which raises rather than fall back)."""
    if P.device.type == "cpu":
        return bridge_plain(P, Wt, Lv, tgt)
    return bridge_cuda(P, Wt, Lv, tgt)


def batch_from_numpy(P, Wt, Lv, tgt, device):
    """The JAX solver's staging arrays (all i32) as the port's tensors on
    `device`."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(dev) for a in (P, Wt, Lv, tgt))


# the byte alignment of every field in a staged row
ALIGN = 16


def packed_layout(V, E, T):
    """The staged row's fields in the C ABI's order, as (name, shape of an
    instance's part, byte offset in the row, fill), all int32, and the
    row's bytes (a multiple of ALIGN)."""
    out, off = [], 0
    for name, shape, fill in (("P", (V, E), -1), ("Wt", (V, E), 0),
                              ("Lv", (V,), 0), ("tgt", (T,), -1)):
        out.append((name, shape, off, fill))
        off += -(-int(np.prod(shape)) * 4 // ALIGN) * ALIGN
    return tuple(out), off


def input_views(packed, layout):
    """bridge_plain's four inputs as int32 views of packed rows ([rows, row
    bytes] uint8, on any device): no copy."""
    words = packed.view(torch.int32)
    return tuple(words[:, off // 4:off // 4 + int(np.prod(shape))]
                 .unflatten(1, shape) if len(shape) > 1
                 else words[:, off // 4:off // 4 + shape[0]]
                 for _, shape, off, _ in layout)


class DeviceBridge:
    """Pinned-shape batch solver for production wave bridging
    (meta/device_wave.py): one dispatch computes the top-K stack DP for up
    to `batch` pier-DP instances paused across a region wave's groups.  It
    ships the live rows only, and runs the DP once on each device of the
    mesh.

    The staging rows live in one pinned buffer, an instance a row
    (packed_layout: P, Wt, Lv and tgt at 16-byte aligned offsets of the
    row), so on a card a dispatch is one copy of its rows in, into a buffer
    that stays on the card, one launch of the kernel over strided views of
    it, and one copy of the three outputs, which the kernel writes into one
    device buffer, into pinned memory, behind one sync.  The views and the
    kernel's checked arguments are made once for each number of rows a
    dispatch ships."""

    def __init__(self, batch=DEFAULT_B, maxv=DEFAULT_V, maxe=DEFAULT_E,
                 maxt=DEFAULT_T, device=None):
        self.batch = batch
        self.maxv = maxv
        self.maxe = maxe
        self.maxt = maxt
        self.device = port_device() if device is None else torch.device(device)
        pin = self.device.type == "cuda"
        self.layout, self.row_bytes = packed_layout(maxv, maxe, maxt)
        # the staging rows; the native export writes them through the
        # numpy views below
        self._packed = torch.zeros((batch, self.row_bytes), dtype=torch.uint8,
                                   pin_memory=pin)
        buf = self._packed.numpy()
        for name, shape, off, fill in self.layout:
            inner = tuple(int(np.prod(shape[k + 1:])) * 4
                          for k in range(len(shape)))
            view = np.ndarray((batch,) + shape, np.int32, buffer=buf,
                              offset=off, strides=(self.row_bytes,) + inner)
            view[...] = fill
            setattr(self, name, view)
        # the outputs' host copy: ostk [rows, T, K, S], par, pix [rows, V,
        # K], one after the other
        self._out_row = maxt * K * S + 2 * maxv * K
        self._out = torch.empty(batch * self._out_row, dtype=torch.int32,
                                pin_memory=pin)
        # on each card: (its input and output buffers, CUDA events), and by
        # (card, rows) the launch's plan (_plan)
        self._cards = {}
        self._plans = {}
        # bridge_device_time: host clock of solve() (the copies, the DP,
        # the sync), s; bridge_kernel_time: launch to completion, s: CUDA
        # events on the stream around each launch, read at the dispatch's
        # sync (the kernel's device time and any wait of the card, after
        # the copy in, for the launch to be queued); bridge_sync_time: the
        # host blocked in the dispatch's sync, s;
        # bridge_launches: kernel launches of its dispatches
        self.stats = {"bridge_dispatches": 0, "bridge_instances": 0,
                      "bridge_device_time": 0.0, "bridge_kernel_time": 0.0,
                      "bridge_sync_time": 0.0, "bridge_launches": 0}

    def row(self, i):
        """Writable (P, Wt, Lv, tgt) slices for the native export."""
        return self.P[i], self.Wt[i], self.Lv[i], self.tgt[i]

    def solve(self, nrows):
        """(ostk [n,T,K,S], par [n,V,K], pix [n,V,K]) int32, C-contiguous
        host arrays of their own, for the first nrows batch slots."""
        t0 = time.perf_counter()
        n0 = bridge_cuda.launches
        # several devices: the rows split over them (ops/meshing.py)
        shards, split = shard_args([self._packed[:nrows]], self.stats,
                                   self.device)
        parts = [self._dp(dev, staged[0]) for dev, staged in shards]
        ostk, par, pix = join_rows(parts, split)
        account_out((ostk, par, pix), self.stats, self.device)
        self.stats["bridge_device_time"] += time.perf_counter() - t0
        self.stats["bridge_dispatches"] += 1
        self.stats["bridge_instances"] += nrows
        self.stats["bridge_launches"] += bridge_cuda.launches - n0
        return ostk, par, pix

    def _split_out(self, flat, rows):
        """ostk, par, pix of `rows` rows laid one after the other in a
        flat int32 tensor (the kernel's outputs), as views."""
        T, V = self.maxt, self.maxv
        a = rows * T * K * S
        b = a + rows * V * K
        return (flat[:a].view(rows, T, K, S), flat[a:b].view(rows, V, K),
                flat[b:b + rows * V * K].view(rows, V, K))

    def _plan(self, dev, rows):
        """(input rows, output buffer, the launch's C arguments) of a
        dispatch of `rows` rows on card `dev`, made on its first use."""
        plan = self._plans.get((dev, rows))
        if plan is None:
            if dev not in self._cards:
                self._cards[dev] = (
                    torch.empty((self.batch, self.row_bytes),
                                dtype=torch.uint8, device=dev),
                    torch.empty(self._out.shape, dtype=torch.int32,
                                device=dev),
                    tuple(torch.cuda.Event(enable_timing=True)
                          for _ in range(2)))
            dpacked, dout, _ = self._cards[dev]
            buf = dout[:rows * self._out_row]
            _, c_args = kernel_args(
                *input_views(dpacked[:rows], self.layout),
                outs=self._split_out(buf, rows))
            plan = self._plans[dev, rows] = (dpacked[:rows], buf, c_args)
        return plan

    def _dp(self, dev, packed):
        """The DP on `dev` over packed staged rows: one copy in, one kernel
        launch and one copy out on a card, the plain form on the CPU;
        C-contiguous host arrays of their own."""
        rows = packed.shape[0]
        if dev.type != "cuda":
            out = bridge_plain(*input_views(packed, self.layout))
            return tuple(t.numpy() for t in out)
        dpacked, buf, c_args = self._plan(dev, rows)
        start, end = self._cards[dev][2]
        host = self._out[:buf.numel()]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            dpacked.copy_(packed, non_blocking=True)
            start.record()
            launch(c_args, dev, stream=stream)
            end.record()
            host.copy_(buf, non_blocking=True)
            t0 = time.perf_counter()
            stream.synchronize()
            self.stats["bridge_sync_time"] += time.perf_counter() - t0
        self.stats["bridge_kernel_time"] += start.elapsed_time(end) / 1e3
        # one copy out of the pinned buffer, which the next dispatch
        # overwrites; the three outputs are views of it
        return tuple(t.numpy() for t in self._split_out(
            torch.from_numpy(host.numpy().copy()), rows))


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
    """Numpy oracle with identical semantics (tests pin bridge_plain ==
    the kernel == this == the solver.py DP)."""
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
