"""Pinned-shape batch solver for the device scallop ladder.

Counterpart of aletsch_tpu/ops/ladder_device.py (DeviceLadder), with the
same surface for meta/device_wave.py at pause kind 4: the native export
fills rows with each paused graph's pre-ladder dense state, one solve()
runs the whole resolution-arm prefix for every exported graph in a single
dispatch of ops/ladder_kernel.py, and the native consume replays the
decision logs with full metadata (native/core_scallop.h ladder_replay).
Trust/verify mode follows the fused-drain probe (ops/greedy_fused.py
device_f64_exact).  On a CUDA device a dispatch is one launch of the
hand-written kernel (csrc/ladder.cu, ladder_kernel.launch) on each
card of the mesh, which runs every graph's whole loop with no host read in
between; it ships its live rows and, behind them, staged rows up to the
next power of two (the batch sizes the solver has always shipped),
switched off (nv = 0): such a row costs its block one read of nv.

The staging rows live in one pinned buffer, a graph a row (packed_layout:
each of the 12 fields the native export writes at a 16-byte aligned
offset of the row), so the rows a dispatch ships go to the card in one
copy, into a buffer that stays on the card, and the kernel reads its 17
inputs as strided views of it.  The four outputs the solver reads and the
event counts land in one device buffer that comes back in one copy, into
pinned memory, behind one sync; the kernel stores none of the other nine.
The views and the kernel's checked arguments are made once for each
number of rows a dispatch ships (a power of two), so a dispatch runs no
check and builds no view."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device as port_device
from . import ladder_kernel as lk
from ._replay import bucket
from .meshing import account_out, join_rows, shard_args

# the byte alignment of every field in a staged row
ALIGN = 16


def packed_layout(V, E, H, L):
    """The staged row's fields in the C ABI's order, as (name, numpy dtype,
    shape of a graph's part, byte offset in the row, fill), and the row's
    bytes (a multiple of ALIGN)."""
    i32, f64, u8 = np.int32, np.float64, np.uint8
    fields = (("esrc", i32, (E,), -1), ("edst", i32, (E,), -1),
              ("ewrt", f64, (E,), 0), ("estr", i32, (E,), 0),
              ("esin", i32, (E,), 0), ("esout", i32, (E,), 0),
              ("ealive", u8, (E,), 0),
              ("meta3", i32, (3,), 0),     # nedges, nstamp, nv
              ("nz", u8, (V,), 0), ("hedge", i32, (H, L), -1),
              ("hlen", i32, (H,), 0),
              ("scal", f64, (4,), 0))      # jump, smallr, guard, smin
    out, off = [], 0
    for name, dtype, shape, fill in fields:
        out.append((name, np.dtype(dtype), shape, off, fill))
        off += -(-int(np.prod(shape)) * np.dtype(dtype).itemsize // ALIGN) \
            * ALIGN
    return tuple(out), off


def input_views(packed, layout):
    """ladder()'s 17 inputs as views of packed rows ([rows, row bytes]
    uint8, on any device): no copy; the booleans are the bytes themselves
    (the export writes 0 or 1)."""
    typed = {np.dtype(np.int32): packed.view(torch.int32),
             np.dtype(np.float64): packed.view(torch.float64),
             np.dtype(np.uint8): packed}
    f = {}
    for name, dtype, shape, off, _ in layout:
        n = int(np.prod(shape))
        t = typed[dtype][:, off // dtype.itemsize:off // dtype.itemsize + n]
        f[name] = t.unflatten(1, shape) if len(shape) > 1 else t
    meta, scal = f["meta3"], f["scal"]
    return (f["esrc"], f["edst"], f["ewrt"], f["estr"], f["esin"],
            f["esout"], f["ealive"].view(torch.bool), meta[:, 0],
            meta[:, 1], f["nz"].view(torch.bool), f["hedge"], f["hlen"],
            meta[:, 2], scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3])


class DeviceLadder:
    def __init__(self, batch=lk.DEFAULT_B, maxv=lk.DEFAULT_V,
                 maxe=lk.DEFAULT_E, maxh=lk.DEFAULT_H, maxl=lk.DEFAULT_L,
                 dmax=lk.DEFAULT_DMAX, dlog=lk.DEFAULT_DLOG, device=None):
        self.batch = batch
        self.maxv = maxv
        self.maxe = maxe
        self.maxh = maxh
        self.maxl = maxl
        self.dmax = dmax
        self.dlog = dlog
        self.device = port_device() if device is None else torch.device(device)
        pin = self.device.type == "cuda"
        self.layout, self.row_bytes = packed_layout(maxv, maxe, maxh, maxl)
        # the staging rows; the native export writes them through the
        # numpy views below, in the C ABI's order
        self._packed = torch.zeros((batch, self.row_bytes), dtype=torch.uint8,
                                   pin_memory=pin)
        buf = self._packed.numpy()
        for name, dtype, shape, off, fill in self.layout:
            inner = tuple(int(np.prod(shape[k + 1:])) * dtype.itemsize
                          for k in range(len(shape)))
            view = np.ndarray((batch,) + shape, dtype, buffer=buf,
                              offset=off, strides=(self.row_bytes,) + inner)
            view[...] = fill
            setattr(self, name, view)
        # the outputs' host copy: larm, ltgt [rows, DLOG], ndec, status,
        # events [rows], int32, one after the other
        self._out = torch.empty(batch * (2 * dlog + 3), dtype=torch.int32,
                                pin_memory=pin)
        # on each card: (its input and output buffers, CUDA events), and by
        # rows the launch's plan (_plan)
        self._cards = {}
        self._plans = {}
        # ladder_device_time: host clock of solve() (the copies, the
        # kernel's launch or the plain lockstep loop, the sync), s;
        # ladder_kernel_time: the kernel's device time (CUDA events around
        # each launch, read at the dispatch's sync), s
        self.stats = {"ladder_dispatches": 0, "ladder_graphs": 0,
                      "ladder_device_time": 0.0, "ladder_kernel_time": 0.0,
                      "ladder_decisions": 0, "ladder_iterations": 0}

    def row(self, i):
        """Writable slices for the native export, in the C ABI's order."""
        return (self.esrc[i], self.edst[i], self.ewrt[i], self.estr[i],
                self.esin[i], self.esout[i], self.ealive[i], self.meta3[i],
                self.nz[i], self.hedge[i], self.hlen[i], self.scal[i])

    def stage_states(self, arr, n):
        """Write the first n packed states of ladder_kernel.pack_states
        into the staging rows, as the native export lays them out."""
        for name in ("esrc", "edst", "ewrt", "estr", "esin", "esout",
                     "ealive", "nz", "hedge", "hlen"):
            getattr(self, name)[:n] = arr[name][:n]
        for col, name in enumerate(("nedges", "nstamp", "nv")):
            self.meta3[:n, col] = arr[name][:n]
        for col, name in enumerate(("jump", "smallr", "guard", "smin")):
            self.scal[:n, col] = arr[name][:n]

    def solve(self, nrows):
        """(larm [n,DLOG] i32, ltgt [n,DLOG] i32, ndec [n] i32, status [n]
        i32) as C-contiguous host arrays of their own, for the first nrows
        staged graphs."""
        t0 = time.perf_counter()
        rows = bucket(nrows, self.batch) if self.device.type == "cuda" \
            else nrows
        self.meta3[nrows:rows, 2] = 0          # stale rows inactive
        # several devices: the graphs split over them (ops/meshing.py)
        shards, split = shard_args([self._packed[:rows]], self.stats,
                                   self.device)
        parts = [self._ladder(dev, staged[0]) for dev, staged in shards]
        larm, ltgt, ndec, status = (a[:nrows]
                                    for a in join_rows(parts, split))
        account_out((larm, ltgt, ndec, status), self.stats, self.device)
        self.stats["ladder_device_time"] += time.perf_counter() - t0
        self.stats["ladder_dispatches"] += 1
        self.stats["ladder_graphs"] += nrows
        self.stats["ladder_decisions"] += int(ndec.sum())
        return larm, ltgt, ndec, status

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
            D = self.dlog
            buf = dout[:rows * (2 * D + 3)]
            lt = buf[:2 * rows * D].view(2, rows, D)
            small = buf[2 * rows * D:].view(3, rows)
            outs = (lt[0], lt[1], small[0], small[1]) + (None,) * 9 \
                + (small[2],)
            views = input_views(dpacked[:rows], self.layout)
            _, c_args = lk.kernel_args(views, self.dmax, D, outs=outs)
            plan = self._plans[dev, rows] = (dpacked[:rows], buf, c_args)
        return plan

    def _ladder(self, dev, packed):
        """The ladder on `dev` over packed staged rows: one copy in, one
        kernel launch and one copy out on a card, the plain loop on the
        CPU; C-contiguous host arrays of larm, ltgt, ndec, status."""
        D = self.dlog
        rows = packed.shape[0]
        if dev.type != "cuda":
            out = lk.ladder_plain(*input_views(packed, self.layout),
                                  DMAX=self.dmax, DLOG=D, with_events=True)
            larm, ltgt, ndec, status = (t.numpy() for t in out[:4])
            events = out[-1].numpy()
        else:
            dpacked, buf, c_args = self._plan(dev, rows)
            start, end = self._cards[dev][2]
            host = self._out[:buf.numel()]
            with torch.cuda.device(dev):
                dpacked.copy_(packed, non_blocking=True)
                start.record()
                lk.launch(c_args, dev)
                end.record()
                host.copy_(buf, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
            self.stats["ladder_kernel_time"] += \
                start.elapsed_time(end) / 1e3
            h = host.numpy()
            larm = h[:rows * D].reshape(rows, D).copy()
            ltgt = h[rows * D:2 * rows * D].reshape(rows, D).copy()
            ndec, status, events = h[2 * rows * D:].reshape(3, rows).copy()
        it = int(events.max()) if len(events) else 0
        self.stats["ladder_iterations"] += it
        return larm, ltgt, ndec, status
