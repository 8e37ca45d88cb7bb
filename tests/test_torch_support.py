"""The port's support reduce (aletsch_tpu_torch/ops/support.py) against the
JAX package's (aletsch_tpu/ops/support.py, the jitted XLA program on the
CPU) and both numpy oracles, on the same numpy-seeded inputs.  Tolerance
zero: the f32 sums are compared with array_equal (under the native export's
integer gate an f32 sum is exact whatever its order)."""

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import support as ref
from aletsch_tpu_torch.ops import support as port


def _weights(seed, n, ns=ref.DEFAULT_NS, j=ref.DEFAULT_J, top=1000):
    """Non-negative integral weights whose totals stay below 2^24, as the
    native export gates them."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, top, size=(n, ns, j)).astype(np.float32)


@pytest.mark.parametrize("n,top", [(1, 1000), (8, 1000), (64, 1000),
                                   (8, 2 ** 20), (8, 2)])
def test_port_matches_jax_and_oracles(n, top):
    jw = _weights(n, n, top=top)
    got = port.support_sum(torch.from_numpy(jw))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, jw.shape[2])
    got = got.numpy()
    assert np.array_equal(got, np.asarray(ref.get_support_fn()(jw)))
    assert np.array_equal(got, port.support_sum_host(jw))
    assert np.array_equal(got, ref.support_sum_host(jw))
    assert np.array_equal(got.astype(np.float64),
                          jw.astype(np.float64).sum(axis=1))


@pytest.mark.parametrize("nrows", [1, 5, 8])
def test_solver_ships_only_the_live_rows(nrows):
    B, NS, J = 8, 4, 16
    jw = _weights(3, B, NS, J)
    dev = port.DeviceSupport(batch=B, maxs=NS, maxj=J, device="cpu")
    for i in range(B):
        dev.row(i)[...] = jw[i]
    got = dev.solve(nrows)
    assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    assert got.shape == (nrows, J)
    assert np.array_equal(got, np.asarray(
        ref.get_support_fn(NS, J)(jw))[:nrows])
    assert dev.stats["support_dispatches"] == 1
    assert dev.stats["support_groups"] == nrows
    assert dev.stats["support_device_time"] > 0.0


def test_default_shapes():
    dev = port.DeviceSupport(device="cpu")
    assert dev.jw.shape == (ref.DEFAULT_B, ref.DEFAULT_NS, ref.DEFAULT_J)
    assert dev.row(3).shape == (ref.DEFAULT_NS, ref.DEFAULT_J)
    assert dev.row(3).base is not None      # a view of the staging batch
