"""Sentinels and pinned batch shapes of the port's device solvers.

The port owns them: the JAX package defines the same values in modules
that import jax (aletsch_tpu/ops/greedy_fused.py, greedy_dp.py,
bridge_dp.py, pallas_drain.py), and the port imports none of those.
tests/test_torch_bottleneck.py pins every value here equal to its JAX
counterpart.  The CUDA sources hard-code the same sentinels as
-1.0e18 / 1.0e18 in the kernel's type (f64, or f32 as np.float32 rounds
them).
"""

from __future__ import annotations

NEG = -1.0e18       # absent edge / unreachable vertex
POS = 1.0e18        # the source's own bottleneck

# fused drain (ops/greedy_fused.py): graphs per launch, padded vertex
# count, path rows returned per graph
DRAIN_B = 64
DRAIN_V = 64
DRAIN_P = 64

# step-mode solver (ops/greedy_dp.py): graphs per launch, padded vertex
# count
STEP_B = 64
STEP_V = 64
