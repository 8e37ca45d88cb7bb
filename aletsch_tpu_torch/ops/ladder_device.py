"""Pinned-shape batch solver for the device scallop ladder.

Counterpart of aletsch_tpu/ops/ladder_device.py (DeviceLadder), with the
same surface for meta/device_wave.py at pause kind 4: the native export
fills rows with each paused graph's pre-ladder dense state, one solve()
runs the whole resolution-arm prefix for every exported graph in a single
dispatch of ops/ladder_kernel.py, and the native consume replays the
decision logs with full metadata (native/core_scallop.h ladder_replay).
Trust/verify mode follows the fused-drain probe (ops/greedy_fused.py
device_f64_exact).  On a CUDA device the loop's body is replayed as a CUDA
graph (ladder_kernel.LadderReplay), recorded for batch sizes that are
powers of two: a dispatch ships its live rows and, behind them, staged
rows up to the next such size, switched off (nv = 0)."""

from __future__ import annotations

import time

import torch

from ..device import device as port_device
from . import ladder_kernel as lk
from ._replay import bucket
from .meshing import account_out, join_rows, shard_args


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
        B, V, E, H, L = batch, maxv, maxe, maxh, maxl
        i32, f64, u8 = torch.int32, torch.float64, torch.uint8

        def full(shape, fill, dtype):
            return torch.full(shape, fill, dtype=dtype, pin_memory=pin)

        # staging rows in the C ABI's order; the native export writes them
        # through the numpy views below
        self._stage = (
            full((B, E), -1, i32),      # esrc
            full((B, E), -1, i32),      # edst
            full((B, E), 0, f64),       # ewrt
            full((B, E), 0, i32),       # estr
            full((B, E), 0, i32),       # esin
            full((B, E), 0, i32),       # esout
            full((B, E), 0, u8),        # ealive
            full((B, 3), 0, i32),       # meta3: nedges, nstamp, nv
            full((B, V), 0, u8),        # nz
            full((B, H, L), -1, i32),   # hedge
            full((B, H), 0, i32),       # hlen
            full((B, 4), 0, f64))       # scal: jump, smallr, guard, smin
        (self.esrc, self.edst, self.ewrt, self.estr, self.esin, self.esout,
         self.ealive, self.meta3, self.nz, self.hedge, self.hlen,
         self.scal) = (t.numpy() for t in self._stage)
        self._replay = lk.LadderReplay(
            V, E, H, L, dmax, dlog, self.device) \
            if self.device.type == "cuda" else None
        # the replays by device: this solver's own, and one for each other
        # card of a mesh (ops/meshing.py)
        self._replays = {self.device: self._replay}
        # ladder_device_time: host clock of solve() (copies, the lockstep
        # loop with its one host read an iteration, copies back), s
        self.stats = {"ladder_dispatches": 0, "ladder_graphs": 0,
                      "ladder_device_time": 0.0, "ladder_decisions": 0,
                      "ladder_iterations": 0}

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
        i32) as C-contiguous host arrays, for the first nrows staged
        graphs."""
        t0 = time.perf_counter()
        rows = nrows if self._replay is None else bucket(nrows, self.batch)
        self.meta3[nrows:rows, 2] = 0          # stale rows inactive
        # several devices: the graphs split over them (ops/meshing.py)
        shards, split = shard_args([t[:rows] for t in self._stage],
                                   self.stats, self.device)
        parts = [self._ladder(dev, staged) for dev, staged in shards]
        larm, ltgt, ndec, status = (a[:nrows]
                                    for a in join_rows(parts, split))
        account_out((larm, ltgt, ndec, status), self.stats, self.device)
        self.stats["ladder_device_time"] += time.perf_counter() - t0
        self.stats["ladder_dispatches"] += 1
        self.stats["ladder_graphs"] += nrows
        self.stats["ladder_decisions"] += int(ndec.sum())
        return larm, ltgt, ndec, status

    def _ladder(self, dev, staged):
        """The ladder on `dev` over staged rows (each iteration replayed as
        a CUDA graph recorded there); C-contiguous host outputs of the
        first four."""
        (esrc, edst, ewrt, estr, esin, esout, ealive, meta3, nz, hedge,
         hlen, scal) = (t.to(dev, non_blocking=True) for t in staged)
        args = (esrc, edst, ewrt, estr, esin, esout, ealive.to(torch.bool),
                meta3[:, 0].contiguous(), meta3[:, 1].contiguous(),
                nz.to(torch.bool), hedge, hlen, meta3[:, 2].contiguous(),
                scal[:, 0].contiguous(), scal[:, 1].contiguous(),
                scal[:, 2].contiguous(), scal[:, 3].contiguous())
        if self._replay is None:
            out = lk.ladder(*args, DMAX=self.dmax, DLOG=self.dlog,
                            counters=self.stats)
        else:
            if dev not in self._replays:
                self._replays[dev] = lk.LadderReplay(
                    self.maxv, self.maxe, self.maxh, self.maxl, self.dmax,
                    self.dlog, dev)
            with torch.cuda.device(dev):
                out = self._replays[dev](*args, counters=self.stats)
        return tuple(t.contiguous().cpu().numpy() for t in out[:4])
