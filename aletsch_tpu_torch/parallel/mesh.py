"""The batched assembly step on one device.

Counterpart of aletsch_tpu/parallel/mesh.py.  The assembler's parallel
structure (SURVEY §2.8): bundles are embarrassingly data-parallel;
cross-sample merging needs a reduction over the sample axis.  One step
takes a region wave as padded tensors (bundle adjacency, coverage
segments, splice incidence, per-sample junction support) and runs the four
device forms on them: the all-sources bottleneck DP (ops/bridge_dp.py),
the region stats (ops/coverage.py), the similarity product and the
sample-axis support sum.

The same step runs on one device and split over a 2-D mesh ('data',
'sample') of devices (make_mesh, build_sharded_step):

- padded bundle tensors (adjacency, coverage segments, splice incidence)
  split over 'data': each data shard's rows run the step's row-wise forms
  on that shard's device, and its similarity rows against the whole
  incidence;
- per-sample junction-support tensors split over 'sample' as well: each
  device sums its samples, and the partial sums are added in sample order
  on the data shard's device (the all-reduce of the JAX package's mesh).

The CPU tests emulate n devices with a list of n CPU devices; on one card
the same code runs over any number of shards placed on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bridge_dp import bottleneck_all_sources
from ..ops.coverage import region_stats
from ..ops.similarity import _counts


class Mesh:
    """A ('data', 'sample') grid of torch devices: devices[d][s] holds data
    shard d's rows of sample shard s."""

    def __init__(self, grid):
        self.devices = [list(row) for row in grid]
        self.shape = {"data": len(self.devices),
                      "sample": len(self.devices[0])}
        self.size = self.shape["data"] * self.shape["sample"]


def make_mesh(n_devices=None, sample_axis=None, devices=None):
    """The first n_devices of `devices` (default: the process-local devices
    of the port's device, ops/meshing.py) as a (data, sample) grid, with
    the JAX package's axis rule: a sample axis of 2 where the count is even,
    else 1."""
    if devices is None:
        from ..device import device as port_device
        from ..ops.meshing import _local_devices
        devices = _local_devices(port_device())
    devs = list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if sample_axis is None:
        sample_axis = 2 if n % 2 == 0 and n >= 2 else 1
    data_axis = n // sample_axis
    return Mesh([devs[d * sample_axis:(d + 1) * sample_axis]
                 for d in range(data_axis)])


def _bundle_rows(W, seg_vals, seg_lens, seg_mask, span):
    """The step's row-wise forms: (bottleneck, ave, dev, mx), each [B]."""
    V = W.shape[1]
    bottleneck = bottleneck_all_sources(W)[:, 0, V - 1]
    ave, dev, mx = region_stats(seg_vals, seg_lens, seg_mask, span,
                                empty_defaults=False)
    return bottleneck, ave, dev, mx


def _sample_sum(jsup):
    """The sum over the sample axis, one add a sample in the samples'
    order: numpy's order for this axis, so the sums equal the oracle's bit
    for bit whatever the weights (torch.sum fixes no order)."""
    support = jsup[0]
    for s in range(1, jsup.shape[0]):
        support = support + jsup[s]
    return support


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
    bottleneck, ave, dev, mx = _bundle_rows(W, seg_vals, seg_lens, seg_mask,
                                            span)
    return bottleneck, ave, dev, mx, _counts(inc), _sample_sum(jsup)


def build_sharded_step(mesh):
    """The step split over `mesh` as the JAX package's in_shardings split
    it: W, seg_*, span and inc by rows over 'data', jsup by samples over
    'sample' and by rows over 'data'.  Returns sharded(W, seg_vals,
    seg_lens, seg_mask, span, inc, jsup) -> the step's six outputs,
    gathered in row order on the mesh's first device.  Rows must divide by
    the data axis and samples by the sample axis, as for an even
    NamedSharding."""
    D, S = mesh.shape["data"], mesh.shape["sample"]
    first = mesh.devices[0][0]

    def sharded(W, seg_vals, seg_lens, seg_mask, span, inc, jsup):
        B, Ns = W.shape[0], jsup.shape[0]
        if B % D or Ns % S:
            raise ValueError("a batch of %d rows and %d samples does not "
                             "split over a %d x %d mesh" % (B, Ns, D, S))
        b, ns = B // D, Ns // S
        shards = []
        for d, row in enumerate(mesh.devices):
            rows = slice(d * b, (d + 1) * b)
            dev = row[0]
            part = _bundle_rows(*(t[rows].to(dev) for t in (
                W, seg_vals, seg_lens, seg_mask, span)))
            sim = _counts(inc[rows].to(dev), inc.to(dev))
            # each device of the data shard sums its samples; the partials
            # add in sample order on the shard's device
            partials = [_sample_sum(jsup[s * ns:(s + 1) * ns, rows]
                                    .to(row[s])) for s in range(S)]
            support = partials[0].to(dev)
            for p in partials[1:]:
                support = support + p.to(dev)
            shards.append((*part, sim, support))
        return tuple(torch.cat([o[i].to(first) for o in shards])
                     for i in range(6))

    return sharded


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
