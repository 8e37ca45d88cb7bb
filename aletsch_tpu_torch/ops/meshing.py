"""Device-mesh plumbing for the wave solvers, PyTorch port.

Counterpart of aletsch_tpu/ops/meshing.py.  When the process sees more
than one device of a solver's type (several cards; the CPU device is one),
every wave batch is split over them: each device owns B/n rows of the
batch, and the solver runs its routine once a chunk on that chunk's device
(the drain kernel launched there, a CUDA graph recorded there), then joins
the host rows in order.  A batch whose rows do not divide by n is
replicated: every device runs it whole, as a replicated SPMD program does,
and the rows are read from the first.  With one device everything is the
plain path: no copy, no stats.

The solvers (ops/greedy_fused.py, ops/bridge_topk.py, ops/support.py,
ops/ladder_device.py) call `shard_args` on their live staging rows right
before a dispatch and `account_out` on its host outputs, which accounts
the bytes with the JAX package's formula (its callers replicate nothing
beside the batch, so neither does this one), so the multi-device dry run
can assert the scaling shape (bytes moved, dispatches) on any machine.
"""

from __future__ import annotations

import numpy as np


def _local_devices(device):
    """The process-local devices of `device`'s type: every CUDA device for
    a card, the one CPU device otherwise.  Tests emulate n devices by
    replacing this function."""
    import torch
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def get_mesh(device):
    """The list of the n > 1 local devices of `device`'s type (a solver's
    device) that the batches split over, or None (one device)."""
    devs = _local_devices(device)
    return devs if len(devs) > 1 else None


def shard_args(batched, stats, device):
    """Place the live wave tensors on the mesh of `device`'s type: split by
    rows into n chunks, one on each device, or whole on every device when
    the rows do not divide by n.  Returns (shards, split): shards is a list
    of (device, tensors') in device order, split says whether their rows
    are disjoint chunks in order (join_rows concatenates them) or copies
    of the whole batch (join_rows reads the first).  With one device:
    [(device, batched)], the tensors as given, no copy and no stats.
    Accounts mesh stats in place."""
    m = get_mesh(device)
    if m is None:
        return [(device, batched)], False
    n = len(m)
    rows = batched[0].shape[0]
    split = rows % n == 0
    step = rows // n
    shards = [(dev, [(a[i * step:(i + 1) * step] if split else a)
                     .to(dev, non_blocking=True) for a in batched])
              for i, dev in enumerate(m)]
    stats["mesh_devices"] = n
    stats["mesh_dispatches"] = stats.get("mesh_dispatches", 0) + 1
    stats["mesh_bytes_in"] = stats.get("mesh_bytes_in", 0) + sum(
        int(a.nbytes) for a in batched)
    return shards, split


def join_rows(parts, split):
    """The host outputs of every shard (a list, in shard order, of tuples of
    numpy arrays) as one tuple of C-contiguous arrays: the chunks' rows
    concatenated in order, or the first shard's when the batch was
    replicated."""
    if len(parts) == 1 or not split:
        return parts[0]
    return tuple(np.ascontiguousarray(np.concatenate(cols, axis=0))
                 for cols in zip(*parts))


def account_out(outs, stats, device):
    """Accumulate output bytes for the mesh accounting."""
    if get_mesh(device) is None:
        return
    stats["mesh_bytes_out"] = stats.get("mesh_bytes_out", 0) + \
        sum(int(getattr(o, "nbytes", 0)) for o in outs)
