"""The batched assembly step on one device.

Counterpart of aletsch_tpu/parallel/mesh.py.  The assembler's parallel
structure (SURVEY §2.8): bundles are embarrassingly data-parallel;
cross-sample merging needs a reduction over the sample axis.  One step
takes a region wave as padded tensors (bundle adjacency, coverage
segments, splice incidence, per-sample junction support) and runs the four
device forms on them: the all-sources bottleneck DP (ops/bridge_dp.py),
the region stats (ops/coverage.py), the similarity product and the
sample-axis support sum.

This module holds the step on one device.  Splitting a batch over several
cards (the reference's make_mesh / build_sharded_step) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bridge_dp import bottleneck_all_sources
from ..ops.coverage import region_stats
from ..ops.similarity import _counts


def step(W, seg_vals, seg_lens, seg_mask, span, inc, jsup):
    """One batched assembly compute wave, on the tensors' device.

    W:        [B, V, V]  bundle adjacency (bottleneck DP)
    seg_*:    [B, S]     coverage segments (region stats)
    span:     [B]
    inc:      [B, P]     splice incidence (pairwise similarity matmul)
    jsup:     [Ns, B, J] per-sample junction support (sum over samples)

    Returns (bottleneck [B], ave [B], dev [B], mx [B], sim [B, B],
    support [B, J]).  bottleneck, mx, sim and support are exact (min and
    max only; integral counts; sums in a fixed order); ave and dev depend
    on the order of their sums.
    """
    V = W.shape[1]
    bottleneck = bottleneck_all_sources(W)[:, 0, V - 1]
    ave, dev, mx = region_stats(seg_vals, seg_lens, seg_mask, span,
                                empty_defaults=False)
    sim = _counts(inc)
    # reduce over the sample axis, one add a sample in the samples' order:
    # numpy's order for this axis, so the sums equal the oracle's bit for
    # bit whatever the weights (torch.sum fixes no order)
    support = jsup[0]
    for s in range(1, jsup.shape[0]):
        support = support + jsup[s]
    return bottleneck, ave, dev, mx, sim, support


def batch_from_numpy(W, seg_vals, seg_lens, seg_mask, span, inc, jsup,
                     device):
    """The step's seven numpy arrays (example_batch, parallel/wave_extract
    .capture_cohort_tensors) as f32 tensors on `device`."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                 .to(dev)
                 for a in (W, seg_vals, seg_lens, seg_mask, span, inc, jsup))


def outputs_to_numpy(out):
    """The step's six outputs as C-contiguous host arrays."""
    return tuple(np.ascontiguousarray(t.cpu().numpy()) for t in out)


def example_batch(B=8, V=32, S=16, P_=64, Ns=2, J=16, seed=0):
    """Tiny padded batch for compile checks and benchmarks."""
    rng = np.random.default_rng(seed)
    W = np.triu(rng.uniform(0, 10, size=(B, V, V)).astype(np.float32), k=1)
    W *= (rng.uniform(size=(B, V, V)) < 0.3)
    seg_vals = rng.integers(0, 50, size=(B, S)).astype(np.float32)
    seg_lens = rng.integers(1, 200, size=(B, S)).astype(np.float32)
    seg_mask = (rng.uniform(size=(B, S)) < 0.8).astype(np.float32)
    span = np.maximum((seg_lens * seg_mask).sum(axis=1), 1.0).astype(np.float32)
    inc = (rng.uniform(size=(B, P_)) < 0.2).astype(np.float32)
    jsup = rng.uniform(0, 5, size=(Ns, B, J)).astype(np.float32)
    return W, seg_vals, seg_lens, seg_mask, span, inc, jsup
