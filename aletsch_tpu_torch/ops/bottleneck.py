"""Single-source bottleneck DP on tensors: the Hopper kernel and its plain
version.

Counterpart of aletsch_tpu/ops/pallas_kernels.py.  Every function there
that reaches pl.pallas_call computes, for a [B, V, V] f32 batch of graphs
in topological order, T[b, v] = the max over 0 -> v paths of the min edge
weight (T[b, 0] = POS, NEG where v is unreachable):

- _kernel_tile_v2 (TPU kernel #2), NEG form (NEG absent, zero-weight
  edges real), through get_greedy_pallas_fn, the step-mode greedy backend:
  here bottleneck(W, neg_form=True), which ops/greedy_dp.py runs;
- _kernel_tile_v2, positive form (W <= 0 absent), through
  bottleneck_from_source_pallas(version=2): here bottleneck_from_source(
  W, version=2);
- _kernel_tile (TPU kernel #3, v1), through bottleneck_from_source_pallas(
  version=1): here bottleneck_from_source(W, version=1).

- bottleneck_cuda: wrapper of csrc/bottleneck.cu (one block per graph
  stages W into shared memory, one warp runs the chain in push form, T in
  registers); CUDA tensors only.
- bottleneck_torch: the same function in plain PyTorch, vectorised over
  the batch like greedy_dp._build and _kernel_tile_v2; the CPU tests and
  the card's checks compare against it.
- bottleneck: a CPU tensor goes to bottleneck_torch, a CUDA tensor to the
  kernel (which raises rather than fall back).

Both compute min and max only, so they agree bit for bit up to the sign
of a zero: min/max over {-0.0, +0.0} may return either, in numpy, torch,
XLA and on the card alike, and the native consumer reads values only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import device as port_device
from .constants import NEG, POS

MAXV = 64       # the kernel's lane l owns vertices l and l + 32


def _check(W):
    if W.dim() != 3 or W.shape[1] != W.shape[2]:
        raise ValueError("W must be [B, V, V], got %s" % (tuple(W.shape),))
    if W.dtype != torch.float32:
        raise TypeError("W must be float32, got %s" % W.dtype)
    B, V, _ = W.shape
    if not 1 <= V <= MAXV:
        raise ValueError("V=%d outside [1, %d]" % (V, MAXV))
    return B, V


def bottleneck_cuda(W, neg_form):
    """Launch the Hopper kernel on the current stream; no sync.  Returns
    T [B, V] f32 on W's device."""
    B, V = _check(W)
    if W.device.type != "cuda":
        raise ValueError("bottleneck_cuda takes CUDA tensors, got %s"
                         % W.device)
    if not W.is_contiguous():
        raise ValueError("W must be contiguous")
    T = torch.empty((B, V), dtype=torch.float32, device=W.device)
    if B == 0:
        return T
    from ._build import load_library
    lib = load_library()
    fn = lib.aletsch_bottleneck_neg if neg_form \
        else lib.aletsch_bottleneck_pos
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = fn(W.data_ptr(), B, V, T.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("bottleneck kernel launch failed: cudaError %d"
                           % err)
    bottleneck_cuda.launches += 1
    return T


bottleneck_cuda.launches = 0    # kernel launches since the last reset


def bottleneck_torch(W, neg_form):
    """Plain PyTorch DP on any device; same values as the kernel."""
    B, V = _check(W)
    if not neg_form:
        W = torch.where(W > 0, W, torch.tensor(NEG, dtype=W.dtype,
                                               device=W.device))
    T = torch.full((B, V), NEG, dtype=torch.float32, device=W.device)
    T[:, 0] = POS
    for v in range(1, V):
        best = torch.minimum(T, W[:, :, v]).amax(dim=1)
        T[:, v] = torch.maximum(T[:, v], best)
    return T


def bottleneck(W, neg_form):
    """The DP on W's device: plain PyTorch for a CPU tensor, the kernel for
    a CUDA tensor."""
    if W.device.type == "cpu":
        return bottleneck_torch(W, neg_form)
    return bottleneck_cuda(W, neg_form)


def bottleneck_from_source(W, version=2, device=None):
    """T[b, v] = bottleneck of the best 0 -> v path, positive form (W <= 0
    is absent), as bottleneck_from_source_pallas: W [B, V, V] numpy in,
    T [B, V] f32 numpy out, on `device` (default: the port's device).

    version=1 and version=2 run the same kernel instance: the TPU's v1
    read column v through a lane mask only because the TPU bans dynamic
    lane indexing (pallas_kernels.py:10-17), and the card has no such ban.
    No padding either: the JAX form pads B to its 8-graph tile, and a
    launch here has one block per graph."""
    if version not in (1, 2):
        raise ValueError("version must be 1 or 2, got %r" % (version,))
    dev = port_device() if device is None else torch.device(device)
    Wt = torch.from_numpy(np.ascontiguousarray(W, dtype=np.float32)).to(dev)
    return bottleneck(Wt, neg_form=False).cpu().numpy()
