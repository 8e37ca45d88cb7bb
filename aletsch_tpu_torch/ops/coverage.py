"""Batched coverage statistics over padded segment arrays.

Counterpart of aletsch_tpu/ops/coverage.py.  Vectorized replacement of
evaluate_rectangle (rnacore/interval_map.cc:166-195) for many regions at
once: given per-region segment values/lengths (padded, masked) and the
region span, compute (ave, dev, max) exactly as the reference — gaps count
toward the average but contribute no variance term.

region_stats_host is the numpy oracle, copied.  region_stats is the
reference's traced formula on tensors, in the dtype and on the device it
is given: the standalone form (the JAX package's get_region_stats_fn) and
the wave step it is part of (parallel/mesh.py).  ave and dev are sums, so
they depend on the reduction's order: 1e-6 against the oracle; mx is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def region_stats_host(vals, lens, mask, span):
    """vals/lens/mask: [R, S]; span: [R]. Returns (ave, dev, mx): [R]."""
    vals = np.asarray(vals, dtype=np.float64)
    lens = np.asarray(lens, dtype=np.float64)
    mask = np.asarray(mask, dtype=np.float64)
    span = np.asarray(span, dtype=np.float64)
    vm = vals * mask
    lm = lens * mask
    mx = (vm).max(axis=1)
    tot = (vm * lm).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ave = np.where(span > 0, tot / span, 0.0)
    var = (lm * (vals - ave[:, None]) ** 2 * mask).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        dev = np.sqrt(np.where(span > 0, var / span, 0.0))
    empty = mask.sum(axis=1) == 0
    ave = np.where(empty, 0.0, ave)
    dev = np.where(empty, 1.0, dev)
    mx = np.where(empty, 0.0, mx)
    return ave, dev, mx


def region_stats(vals, lens, mask, span, empty_defaults=True):
    """vals/lens/mask: [R, S] tensors, span: [R], one float dtype, one
    device.  Returns (ave, dev, mx): [R] tensors of that dtype there."""
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    vm = vals * mask
    lm = lens * mask
    mx = torch.amax(vm, dim=1)
    tot = torch.sum(vm * lm, dim=1)
    pos = span > 0
    safe = torch.clamp(span, min=1.0)
    ave = torch.where(pos, tot / safe, zero)
    var = torch.sum(lm * (vals - ave[:, None]) ** 2 * mask, dim=1)
    dev = torch.sqrt(torch.where(pos, var / safe, zero))
    if empty_defaults:
        empty = torch.sum(mask, dim=1) == 0
        ave = torch.where(empty, zero, ave)
        dev = torch.where(empty, zero + 1.0, dev)
        mx = torch.where(empty, zero, mx)
    return ave, dev, mx


def batch_from_numpy(vals, lens, mask, span, device, dtype=torch.float64):
    """The four numpy arrays of a region batch as tensors on `device`."""
    dev = torch.device(device)
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np_dtype))
                 .to(dev) for a in (vals, lens, mask, span))
