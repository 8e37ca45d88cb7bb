"""CUDA-graph replay of plain PyTorch code.

The bridge DP is thousands of small operations on small tensors;
launched one by one the host cannot submit them as fast as the card runs
them.  Recorded once as a CUDA graph and replayed, the same kernels run in
the same order on the same buffers, so the results are the eager ones bit
for bit, and the host pays for one launch.  The bridge solver replays on a
CUDA device; on the CPU there is nothing to replay, and every operation
runs as it comes.
"""

from __future__ import annotations

import torch


def bucket(n, cap):
    """The smallest power of two >= n, at most cap: the batch sizes the
    solvers ship (and the bridge records its graphs for)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class Replay:
    """fn(), which reads and writes only `buffers` (and tensors it makes
    itself), recorded as a CUDA graph.  fn runs once before the recording,
    on a side stream, so that whatever initialises lazily does so outside
    it; the buffers are put back to what they held."""

    def __init__(self, fn, buffers):
        saved = [b.clone() for b in buffers]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        for b, t in zip(buffers, saved):
            b.copy_(t)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn()

    def replay(self):
        self.graph.replay()
        return self.outputs
