"""Batched bottleneck-path DP over dense splice-graph adjacency.

Counterpart of aletsch_tpu/ops/bridge_dp.py.  Both hot DPs of the assembler
are max-min ("bottleneck") path problems over DAGs whose vertex order is
topological (splice-graph vertices are genome-ordered; graph_builder only
creates i < j edges):

- the bridging DP scores candidate mate paths by their minimum edge weight
  (bridge/bridge_solver.cc:484-530; the top-1 stack entry is exactly the
  bottleneck), and
- greedy decomposition repeatedly extracts the max-bottleneck source->sink
  path (rnacore/splice_graph.cc:819-885).

bottleneck_all_sources evaluates, for a batch of padded bundles, the
all-pairs source-conditioned bottleneck table T[b, s, v] = best min-edge
weight over paths s -> v, by a sequential scan over target vertices with
the (max, min) semiring vectorized across batch and sources: V - 1
dependent steps of a few small operations on W's device, min and max
only, so every value is one of W's or a sentinel and the table equals the
numpy oracle's exactly.  Row s = 0 is the single-source table of
ops/bottleneck.py in its positive form.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import NEG, POS


def initial_table(B, V, dtype, device):
    """T0 [B, V, V]: POS on the diagonal, NEG elsewhere.  The diagonal is
    assigned, not computed as eye * (POS - NEG) + NEG: in f32 that sum
    need not round to the f32 POS the oracle holds."""
    T = torch.full((B, V, V), NEG, dtype=dtype, device=device)
    T.diagonal(dim1=1, dim2=2).fill_(POS)
    return T


def bottleneck_all_sources(W):
    """W: [B, V, V] edge weights (<=0 means absent, upper-triangular).

    Returns T: [B, V, V] with T[b, s, v] = bottleneck score of the best
    s->v path (POS on the diagonal, NEG if unreachable), in W's dtype on
    W's device.
    """
    B, V, _ = W.shape
    Wm = torch.where(W > 0, W, torch.full((), NEG, dtype=W.dtype,
                                          device=W.device))
    T = initial_table(B, V, W.dtype, W.device)
    for v in range(1, V):
        # cand[b, s, i] = min(T[b, s, i], W[b, i, v])
        best = torch.minimum(T, Wm[:, None, :, v]).amax(dim=2)     # [B, S]
        T[:, :, v] = torch.maximum(T[:, :, v], best)
    return T


def bottleneck_all_sources_host(W):
    """Reference numpy implementation (oracle for bottleneck_all_sources)."""
    W = np.asarray(W, dtype=np.float64)
    B, V, _ = W.shape
    Wm = np.where(W > 0, W, NEG)
    T = np.full((B, V, V), NEG)
    for b in range(B):
        np.fill_diagonal(T[b], POS)
    for v in range(1, V):
        cand = np.minimum(T, Wm[:, :, v][:, None, :])
        best = cand.max(axis=2)
        T[:, :, v] = np.maximum(T[:, :, v], best)
    return T


def dense_adjacency(gr, V=None):
    """SpliceGraph -> padded dense weight matrix (max over parallel edges)."""
    n = gr.num_vertices()
    V = V or n
    W = np.zeros((V, V), dtype=np.float32)
    for e in gr.edges():
        w = gr.get_edge_weight(e)
        if e.s < V and e.t < V and w > W[e.s, e.t]:
            W[e.s, e.t] = w
    return W
