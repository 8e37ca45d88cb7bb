"""Port's single-source bottleneck DP (aletsch_tpu_torch/ops/bottleneck.py,
ops/greedy_dp.py) vs the JAX package's.

On the CPU the port runs the plain PyTorch version (bottleneck_torch).  In
the NEG form it must equal greedy_dp.single_source_host, the jitted XLA
scan greedy_dp._build and get_greedy_pallas_fn in interpret mode (TPU
kernel #2); in the positive form, bottleneck_from_source_pallas in
interpret mode (versions 1 and 2: TPU kernels #3 and #2) and
bridge_dp.bottleneck_all_sources_host row 0.  The DP is f32 min/max only,
so every comparison is bit for bit on int32 views, after turning -0.0 into
+0.0: min/max over {-0.0, +0.0} may return either zero (numpy, torch and
XLA disagree), and the native consumer reads values only.  The inputs
carry 0.0 and -0.0 edges, so that rule is exercised.  The CUDA kernel takes
the maxima in another order (each destination keeps a running best, sources
in increasing order); that order is emulated here in numpy and held to the
same references.  The CUDA kernel's own check is marked `cuda` and runs
only on a card."""

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import (bridge_dp, greedy_dp, greedy_fused,
                             pallas_drain, pallas_kernels)
from aletsch_tpu_torch.ops import bottleneck as tbn
from aletsch_tpu_torch.ops import constants
from aletsch_tpu_torch.ops import drain as tdrain
from aletsch_tpu_torch.ops import greedy_dp as tgreedy

CPU = torch.device("cpu")
NEGF = np.float32(greedy_dp.NEG)


def _canon(x):
    """int32 view with -0.0 turned into +0.0."""
    x = np.asarray(x, dtype=np.float32)
    return (x + np.float32(0.0)).view(np.int32)


def _same(a, b):
    assert np.asarray(a).shape == np.asarray(b).shape
    assert np.array_equal(_canon(a), _canon(b))


def _xla(W):
    import jax
    import jax.numpy as jnp
    V = W.shape[1]
    return np.asarray(jax.jit(greedy_dp._build(jax, jnp, V))(W))


def _pallas_neg(W, tile=16):
    """get_greedy_pallas_fn needs B % tile == 0: pad with all-NEG rows."""
    B, V, _ = W.shape
    pad = (-B) % tile
    Wp = np.concatenate([W, np.full((pad, V, V), NEGF)]) if pad else W
    fn = pallas_kernels.get_greedy_pallas_fn(V, interpret=True, tile=tile)
    return np.asarray(fn(Wp))[:B]


def _torch_neg(W):
    return tbn.bottleneck(torch.from_numpy(W), neg_form=True).numpy()


@pytest.mark.parametrize("module,names", [
    (greedy_fused, {"NEG": "NEG", "POS": "POS", "DEFAULT_B": "DRAIN_B",
                    "DEFAULT_V": "DRAIN_V", "DEFAULT_P": "DRAIN_P"}),
    (greedy_dp, {"NEG": "NEG", "POS": "POS", "DEFAULT_B": "STEP_B",
                 "DEFAULT_V": "STEP_V"}),
    (bridge_dp, {"NEG": "NEG", "POS": "POS"}),
    (pallas_kernels, {"NEG": "NEG", "POS": "POS"}),
])
def test_constants_match_jax(module, names):
    for jax_name, port_name in names.items():
        assert getattr(constants, port_name) == getattr(module, jax_name), \
            "%s.%s" % (module.__name__, jax_name)


def test_f32_sentinels_match_pallas_drain():
    assert np.float32(constants.NEG).view(np.int32) == \
        pallas_drain.NEGF.view(np.int32)
    assert np.float32(constants.POS).view(np.int32) == \
        pallas_drain.POSF.view(np.int32)
    T = tbn.bottleneck_torch(torch.full((1, 2, 2), constants.NEG), True)
    assert T[0, 0].numpy() == pallas_drain.POSF
    assert T[0, 1].numpy() == pallas_drain.NEGF


@pytest.mark.parametrize("seed,B", [(1, 20), (2, 13)])
def test_neg_form_matches_host_xla_and_pallas(seed, B):
    """Full width, B not a multiple of the Pallas tile; zero-weight,
    -0.0 edges and unreachable vertices in every batch."""
    W = tdrain.fuzz_tables(np.random.default_rng(seed), B, 64)
    t = _torch_neg(W)
    assert t.dtype == np.float32 and t.shape == (B, 64)
    _same(t, greedy_dp.single_source_host(W))
    _same(t, _xla(W))
    _same(t, _pallas_neg(W))


def test_fuzz_tables_cover_the_hard_cases():
    W = tdrain.fuzz_tables(np.random.default_rng(4), 32, 64)
    assert W.dtype == np.float32
    assert np.all(np.tril(np.ones((64, 64), bool))[None] <= (W == NEGF))
    assert ((W == 0) & ~np.signbit(W)).any()         # 0.0 edges
    assert ((W == 0) & np.signbit(W)).any()          # -0.0 edges
    t = _torch_neg(W)
    has_edges = (W > NEGF).any(axis=1)               # [B, V]: in-edges
    assert ((t == NEGF) & has_edges).any()           # cut-off vertices
    assert (t[:, 0] == np.float32(greedy_dp.POS)).all()


def test_neg_form_zero_edges_and_edge_cases():
    """A vertex reached only through 0.0 or -0.0 edges has T = 0 (value);
    an all-NEG row leaves T = [POS, NEG, ...]; V = 1 and V = 33 work."""
    V = 8
    W = np.full((3, V, V), NEGF)
    W[0, 0, 1] = 5.0
    W[0, 1, 2] = np.float32(-0.0)
    W[0, 0, 3] = 0.0
    W[0, 2, 4] = 3.0
    W[0, 3, 4] = 1.0
    W[2, 0, 7] = 2.0
    t = _torch_neg(W)
    assert t[0, 1] == 5.0 and t[0, 2] == 0.0 and t[0, 3] == 0.0
    assert t[0, 4] == 0.0 and (t[0, 5:] == NEGF).all()
    assert t[1, 0] == np.float32(greedy_dp.POS) and (t[1, 1:] == NEGF).all()
    assert t[2, 7] == 2.0
    _same(t, greedy_dp.single_source_host(W))
    _same(t, _xla(W))
    for Wv in (np.full((5, 1, 1), NEGF),
               tdrain.fuzz_tables(np.random.default_rng(33), 5, 33)):
        _same(_torch_neg(Wv), greedy_dp.single_source_host(Wv))


def _push_tables(W, neg_form):
    """The DP in the order the Hopper kernel takes it (csrc/bottleneck.cu,
    "push" form), in numpy f32: each destination v keeps its best so far;
    step u = 0 .. V-2 offers min(T[u], W[u, v]) to every v > u, where T[u]
    is final.  Entries with v <= u are no edges and are never offered."""
    B, V, _ = W.shape
    if not neg_form:
        W = np.where(W > 0, W, NEGF)
    best = np.full((B, V), NEGF)
    best[:, 0] = np.float32(greedy_dp.POS)
    idx = np.arange(V)
    for u in range(V - 1):
        offer = np.where(idx > u, W[:, u, :], NEGF)
        best = np.maximum(best, np.minimum(best[:, u:u + 1], offer))
    return best


@pytest.mark.parametrize("V", [16, 33, 64])
@pytest.mark.parametrize("back_edges", [False, True])
def test_push_order_matches_plain_and_jax(V, back_edges):
    """The kernel's sweep order, emulated on the CPU, against
    bottleneck_torch in both forms and, through the JAX package, against
    the host DP, the XLA scan and the Pallas kernels in interpret mode: bit
    for bit (signed zeros canonicalised) with 0.0 and -0.0 edges,
    unreachable vertices, and entries on and below the diagonal that every
    form must ignore."""
    rng = np.random.default_rng(200 + V)
    W = tdrain.fuzz_tables(rng, 24, V, back_edges=back_edges)
    assert ((W == 0) & np.signbit(W)).any()
    assert ((W == 0) & ~np.signbit(W)).any()
    low = np.tril(np.ones((V, V), dtype=bool))[None]
    assert ((W > NEGF) & low).any() == back_edges
    e = _push_tables(W, True)
    assert e.dtype == np.float32
    _same(e, _torch_neg(W))
    _same(e, greedy_dp.single_source_host(W))
    _same(e, _xla(W))
    if V == 64:
        _same(e, _pallas_neg(W, tile=8))
    if back_edges:
        # the entries on and below the diagonal changed nothing
        _same(e, _torch_neg(np.where(low, NEGF, W)))
    p = _push_tables(W, False)
    _same(p, tbn.bottleneck(torch.from_numpy(W), neg_form=False).numpy())
    for version in (1, 2):
        _same(p, pallas_kernels.bottleneck_from_source_pallas(
            W, interpret=True, version=version))


@pytest.mark.parametrize("version", [1, 2])
def test_positive_form_matches_pallas_and_host(version):
    W = tdrain.fuzz_tables(np.random.default_rng(6 + version), 12, 64)
    t = tbn.bottleneck_from_source(W, version=version, device=CPU)
    assert t.dtype == np.float32 and t.shape == (12, 64)
    _same(t, pallas_kernels.bottleneck_from_source_pallas(
        W, interpret=True, version=version))
    _same(t, bridge_dp.bottleneck_all_sources_host(W)[:, 0, :])
    # 0.0 and -0.0 edges are absent in this form, real in the NEG form
    assert (t == NEGF).sum() > (_torch_neg(W) == NEGF).sum()


@pytest.mark.parametrize("version", [1, 2])
def test_positive_form_disconnected(version):
    W = np.zeros((8, 8, 8), dtype=np.float32)
    t = tbn.bottleneck_from_source(W, version=version, device=CPU)
    _same(t, pallas_kernels.bottleneck_from_source_pallas(
        W, interpret=True, version=version))
    assert (t[:, 0] == np.float32(greedy_dp.POS)).all()
    assert (t[:, 1:] == NEGF).all()


def test_v1_equals_v2_on_the_pallas_test_inputs():
    rng = np.random.default_rng(9)
    W = np.triu(rng.uniform(0, 10, (16, 32, 32)).astype(np.float32), 1)
    W *= (rng.uniform(size=W.shape) < 0.3)
    t1 = tbn.bottleneck_from_source(W, version=1, device=CPU)
    _same(t1, tbn.bottleneck_from_source(W, version=2, device=CPU))
    _same(t1, pallas_kernels.bottleneck_from_source_pallas(
        W, interpret=True, version=1))


def test_solver_matches_jax_solver():
    """The port's DeviceGreedy on the CPU returns what the JAX solver
    returns for the same staged rows, for a full and a partial batch."""
    B, V = 16, 64
    W = tdrain.fuzz_tables(np.random.default_rng(12), B, V)
    jdev = greedy_dp.DeviceGreedy(batch=B, maxv=V)
    tdev = tgreedy.DeviceGreedy(batch=B, maxv=V, device=CPU)
    for i in range(B):
        jdev.row(i)[:] = W[i]
        tdev.row(i)[:] = W[i]
    for nrows in (B, 5):
        got = tdev.solve(nrows)
        assert got.dtype == np.float32 and got.flags.c_contiguous
        assert got.shape == (nrows, V)
        _same(got, jdev.solve(nrows))
    assert tdev.stats["dispatches"] == 2
    assert tdev.stats["graphs"] == B + 5
    tdev.reset_rows(3)
    assert (tdev.W[:3] == NEGF).all()
    _same(tdev.solve(3)[:, 1:], np.full((3, V - 1), NEGF))


def test_solve_zero_rows():
    tdev = tgreedy.DeviceGreedy(device=CPU)
    out = tdev.solve(0)
    assert out.shape == (0, 64) and out.dtype == np.float32
    assert out.flags.c_contiguous
    assert tdev.stats["dispatches"] == 0


def test_single_source_torch_is_the_neg_form():
    W = tdrain.fuzz_tables(np.random.default_rng(3), 4, 24)
    _same(tgreedy.single_source_torch(torch.from_numpy(W)).numpy(),
          greedy_dp.single_source_host(W))


def test_wrapper_checks_inputs():
    W = torch.from_numpy(tdrain.fuzz_tables(np.random.default_rng(2), 2, 16))
    n0 = tbn.bottleneck_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tbn.bottleneck_cuda(W, True)
    with pytest.raises(TypeError, match="float32"):
        tbn.bottleneck(W.double(), True)
    with pytest.raises(ValueError, match="must be"):
        tbn.bottleneck(W[:, :, :8], True)
    with pytest.raises(ValueError, match="must be"):
        tbn.bottleneck(W[0], True)
    with pytest.raises(ValueError, match="outside"):
        tbn.bottleneck(torch.zeros((1, 65, 65)), False)
    with pytest.raises(ValueError, match="version"):
        tbn.bottleneck_from_source(W.numpy(), version=3, device=CPU)
    assert tbn.bottleneck_cuda.launches == n0


@pytest.mark.cuda
def test_bottleneck_cuda_matches_plain_on_card():
    """The Hopper kernel against bottleneck_torch on the card and
    single_source_host, in both forms (needs a GPU and nvcc; python3
    chip_smoke.py runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for V, back_edges in ((16, False), (33, True), (64, False), (64, True)):
        W = tdrain.fuzz_tables(rng, 64, V, back_edges=back_edges)
        Wd = torch.from_numpy(W).to(dev)
        for neg_form in (True, False):
            k = tbn.bottleneck_cuda(Wd, neg_form).cpu().numpy()
            p = tbn.bottleneck_torch(Wd, neg_form).cpu().numpy()
            _same(k, p)
            _same(k, _push_tables(W, neg_form))
            if neg_form:
                _same(k, greedy_dp.single_source_host(W))
            else:
                _same(k, bridge_dp.bottleneck_all_sources_host(W)[:, 0, :])
