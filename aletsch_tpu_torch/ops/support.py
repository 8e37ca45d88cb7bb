"""Wave-batched cross-sample junction-support reduce.

Counterpart of aletsch_tpu/ops/support.py (DeviceSupport, support_sum,
support_sum_host), with the same surface for meta/device_wave.py at pause
kind 3.  The meta assembler stamps every splicing edge of a group's graphs
with its cross-sample abundance sum; jw [n, NS, J] holds each paused
group's per-(sample-slot, junction) weights and the reduce is the
sample-axis sum, one torch.sum on the port's device.

Bit-exactness: the native export (core.cpp GroupRun::support_export) gates
each junction on non-negative integral weights with an f32-exact total
(sum of <= NS integers bounded by max*NS < 2^24), so the f32 sum equals
the host's sorted-key f64 sum whatever the reduction order; gate-failing
junctions keep the host sum.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device as port_device
from .constants import SUPPORT_B, SUPPORT_J, SUPPORT_NS

DEFAULT_B = SUPPORT_B     # groups per dispatch
DEFAULT_NS = SUPPORT_NS   # padded sample slots (larger maps stay on host)
DEFAULT_J = SUPPORT_J     # padded junctions per group (overflow on host)


def support_sum(jw):
    """jw: [n, NS, J] f32 tensor -> [n, J] sample-axis sums."""
    return torch.sum(jw, dim=1)


def support_sum_host(jw):
    """Numpy oracle (tests)."""
    return np.asarray(jw, dtype=np.float32).sum(axis=1)


class DeviceSupport:
    """Pinned-shape batch reducer: the native export fills rows, one
    solve() sums every exported group's junctions."""

    def __init__(self, batch=DEFAULT_B, maxs=DEFAULT_NS, maxj=DEFAULT_J,
                 device=None):
        self.batch = batch
        self.maxs = maxs
        self.maxj = maxj
        self.device = port_device() if device is None else torch.device(device)
        self._stage = torch.zeros((batch, maxs, maxj), dtype=torch.float32,
                                  pin_memory=self.device.type == "cuda")
        self.jw = self._stage.numpy()
        # support_device_time: host clock of solve() (copies, sum, sync), s
        self.stats = {"support_dispatches": 0, "support_groups": 0,
                      "support_device_time": 0.0}

    def row(self, i):
        """Writable [maxs, maxj] slice for the native export."""
        return self.jw[i]

    def solve(self, nrows):
        """[nrows, maxj] f32 per-junction sums of the first nrows staged
        groups, as a C-contiguous host array."""
        t0 = time.perf_counter()
        jw = self._stage[:nrows].to(self.device, non_blocking=True)
        out = support_sum(jw).contiguous().cpu().numpy()
        self.stats["support_device_time"] += time.perf_counter() - t0
        self.stats["support_dispatches"] += 1
        self.stats["support_groups"] += nrows
        return out
