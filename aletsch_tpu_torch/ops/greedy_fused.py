"""Fused greedy drain solver: one drain launch per wave round.

Counterpart of aletsch_tpu/ops/greedy_fused.py (DeviceGreedyFused,
device_f64_exact), with the same surface for meta/device_wave.py: the
native export fills staging rows through row(i), and solve(nrows) drains
every exported graph completely.  The drain runs in f64 on the port's
device (ops/drain.py: the Hopper kernel on CUDA, its plain version on the
CPU), so trust mode holds wherever that device's f64 is IEEE-exact.

The default shapes and the NEG sentinel come from ops/constants.py, which
the tests pin equal to the JAX package's.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..device import device as port_device
from . import drain as drain_ops
from .constants import DRAIN_B, DRAIN_P, DRAIN_V, NEG
from .meshing import account_out, join_rows, shard_args


def device_f64_exact(device=None):
    """True when the device's f64 {sub, min, max} are bit-identical to host
    IEEE f64 (the deterministic battery of the JAX package's
    device_f64_exact).  Chooses trust vs verify mode for the native
    consumer; ALETSCH_FUSED_TRUST=1/0 overrides it."""
    env = os.environ.get("ALETSCH_FUSED_TRUST")
    if env is not None:
        return env == "1"
    dev = port_device() if device is None else torch.device(device)
    rng = np.random.default_rng(12345)
    a = rng.random(512) * 1000.0
    b = rng.random(512) * 997.0
    x = torch.from_numpy(a).to(dev)
    y = torch.from_numpy(b).to(dev)
    out = torch.minimum(torch.maximum(x - y, y - x) - y, x - 0.01)
    host = np.minimum(np.maximum(a - b, b - a) - b, a - 0.01)
    return bool(np.array_equal(out.cpu().numpy().view(np.int64),
                               host.view(np.int64)))


def batch_from_numpy(W, P, sink, scal, device):
    """The JAX solver's staging arrays (W [B,V,V] f64, P [B,V,V] i32,
    sink [B] i32, scal [B,3] f64) as the port's tensors on `device`."""
    dev = torch.device(device)
    return (torch.from_numpy(np.ascontiguousarray(W, dtype=np.float64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(P, dtype=np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(sink, dtype=np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(scal, dtype=np.float64)).to(dev))


class DeviceGreedyFused:
    """Pinned-shape fused drain solver: the native export fills rows, one
    solve() launch drains every exported graph completely."""

    def __init__(self, batch=DRAIN_B, maxv=DRAIN_V, maxp=DRAIN_P,
                 device=None):
        self.batch = batch
        self.maxv = maxv
        self.maxp = maxp
        self.device = port_device() if device is None else torch.device(device)
        pin = self.device.type == "cuda"
        # staging rows: pinned host tensors on CUDA (async H2D); the native
        # export writes them through the numpy views below
        self._stage = (
            torch.full((batch, maxv, maxv), NEG, dtype=torch.float64,
                       pin_memory=pin),
            torch.full((batch, maxv, maxv), -1, dtype=torch.int32,
                       pin_memory=pin),
            torch.zeros(batch, dtype=torch.int32, pin_memory=pin),
            torch.zeros((batch, 3), dtype=torch.float64, pin_memory=pin))
        self.W, self.P, self.sink, self.scal = (t.numpy() for t in self._stage)
        # on each card, the CUDA events around the drain's launch
        self._events = {}
        # fused_device_time: host clock of solve() (copies, launch, sync), s;
        # fused_kernel_time: the kernel's device time (CUDA events around
        # each launch alone, drain.launch_events, read at the dispatch's
        # sync), s; fused_sync_time: the host blocked on the card in the
        # dispatch's copies out, s
        self.stats = {"fused_dispatches": 0, "fused_graphs": 0,
                      "fused_device_time": 0.0, "fused_paths": 0,
                      "fused_kernel_time": 0.0, "fused_sync_time": 0.0,
                      "fused_form": "%s_f64" % self.device.type}

    def row(self, i):
        """Writable (W, P, sink, scal) slices for the native export."""
        return self.W[i], self.P[i], self.sink[i:i + 1], self.scal[i]

    def solve(self, nrows):
        """(paths [n,MAXP,V] bool, ws [n,MAXP] f64, npaths [n] i32) as
        C-contiguous host arrays, for the first nrows staged graphs."""
        if nrows == 0:
            return (np.zeros((0, self.maxp, self.maxv), dtype=bool),
                    np.zeros((0, self.maxp), dtype=np.float64),
                    np.zeros(0, dtype=np.int32))
        t0 = time.perf_counter()
        # several devices: the live rows split over them (ops/meshing.py)
        shards, split = shard_args([t[:nrows] for t in self._stage],
                                   self.stats, self.device)
        parts = [self._drain(dev, args) for dev, args in shards]
        paths, ws, npaths = join_rows(parts, split)
        account_out((paths, ws, npaths), self.stats, self.device)
        self.stats["fused_device_time"] += time.perf_counter() - t0
        self.stats["fused_dispatches"] += 1
        self.stats["fused_graphs"] += nrows
        self.stats["fused_paths"] += int(npaths.sum())
        return paths, ws, npaths

    def _drain(self, dev, args):
        """One drain launch on `dev` over staged rows; host outputs."""
        args = [a.to(dev, non_blocking=True) for a in args]
        if dev.type != "cuda":
            paths, ws, npaths = drain_ops.drain(*args, self.maxp)
            return paths.view(torch.bool).numpy(), ws.numpy(), npaths.numpy()
        events = self._events.get(dev)
        if events is None:
            events = self._events[dev] = tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2))
        with drain_ops.launch_events(*events):
            paths, ws, npaths = drain_ops.drain(*args, self.maxp)
        t0 = time.perf_counter()
        paths = paths.view(torch.bool).cpu().numpy()
        ws = ws.cpu().numpy()
        npaths = npaths.cpu().numpy()
        events[1].synchronize()
        self.stats["fused_sync_time"] += time.perf_counter() - t0
        self.stats["fused_kernel_time"] += \
            events[0].elapsed_time(events[1]) / 1e3
        return paths, ws, npaths
