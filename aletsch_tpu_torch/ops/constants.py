"""Sentinels and pinned batch shapes of the port's device solvers.

The port owns them: the JAX package defines the same values in modules
that import jax or sit beside modules that do (aletsch_tpu/ops/
greedy_fused.py, greedy_dp.py, bridge_dp.py, pallas_drain.py,
bridge_topk.py, support.py), and the port imports none of those.
tests/test_torch_bottleneck.py and tests/test_torch_host_copies.py pin
every value here equal to its JAX counterpart.  The CUDA sources
hard-code the same sentinels as -1.0e18 / 1.0e18 in the kernel's type
(f64, or f32 as np.float32 rounds them).
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

# bridge top-K DP (ops/bridge_topk.py): entries kept per vertex
# (bridge_dp_solution_size), stack depth (bridge_dp_stack_size), the sort
# key of an invalid candidate, the initial stack fill; instances per
# dispatch, padded window, in-edge slots, targets per instance
BRIDGE_K = 10
BRIDGE_S = 5
BRIDGE_BIG = 2 ** 30
BRIDGE_SENTINEL = 999999
BRIDGE_B = 64
BRIDGE_V = 64
BRIDGE_E = 16
BRIDGE_T = 16

# support reduce (ops/support.py): groups per dispatch, padded sample
# slots, padded junctions per group
SUPPORT_B = 64
SUPPORT_NS = 16
SUPPORT_J = 64

# decomposition ladder (ops/ladder_kernel.py): graphs per dispatch
LADDER_B = 64
