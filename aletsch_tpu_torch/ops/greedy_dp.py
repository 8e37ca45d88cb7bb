"""Step-mode greedy solver: one bottleneck-table launch per extraction.

Counterpart of aletsch_tpu/ops/greedy_dp.py (DeviceGreedy), with the same
surface for meta/device_wave.py under ALETSCH_DEVICE_GREEDY=step: the
native export (core_greedy_export) fills one [maxv, maxv] f32 row per
paused graph through row(i), in topological order with NEG where an edge
is absent; solve(nrows) computes every exported graph's table T (the
NEG-form single-source bottleneck DP of ops/bottleneck.py: the Hopper
kernel on CUDA, its plain version on the CPU); the native consumer
(core_greedy_step) backtraces one path from each table.

Differences from the JAX solver:
- solve(nrows) ships and computes the live rows only, where the JAX form
  ships and computes all `batch` rows of every dispatch;
- ALETSCH_PALLAS_GREEDY is not read: in the JAX package it picks between
  the XLA scan and the Pallas kernel, which give the same bits, and the
  port's device has only its kernel;
- no warm-up dispatch: the JAX one exists to compile, and the port builds
  its kernel library on first use.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import device as port_device
from . import bottleneck as bottleneck_ops
from .constants import NEG, STEP_B, STEP_V


def single_source_torch(W):
    """The NEG-form plain version: T [B, V] f32 for W [B, V, V] f32."""
    return bottleneck_ops.bottleneck_torch(W, neg_form=True)


class DeviceGreedy:
    """Pinned-shape batch solver with dispatch statistics."""

    def __init__(self, batch=STEP_B, maxv=STEP_V, device=None):
        self.batch = batch
        self.maxv = maxv
        self.device = port_device() if device is None else torch.device(device)
        # staging rows: a pinned host tensor on CUDA (async H2D); the
        # native export writes it through the numpy view below
        self._stage = torch.full((batch, maxv, maxv), NEG,
                                 dtype=torch.float32,
                                 pin_memory=self.device.type == "cuda")
        self.W = self._stage.numpy()
        # device_time: host clock of solve() (copy, launch, sync), s
        self.stats = {"dispatches": 0, "graphs": 0, "device_time": 0.0}

    def row(self, i):
        """Writable [maxv, maxv] slice for the native export to fill."""
        return self.W[i]

    def solve(self, nrows):
        """Tables for the first nrows staged graphs: a C-contiguous
        [nrows, maxv] f32 host array (the native consumer reads each row
        through raw ctypes.data)."""
        if nrows == 0:
            return np.zeros((0, self.maxv), dtype=np.float32)
        t0 = time.perf_counter()
        W = self._stage[:nrows].to(self.device, non_blocking=True)
        out = bottleneck_ops.bottleneck(W, neg_form=True).cpu().numpy()
        self.stats["device_time"] += time.perf_counter() - t0
        self.stats["dispatches"] += 1
        self.stats["graphs"] += nrows
        return out

    def reset_rows(self, nrows):
        self.W[:nrows] = NEG
