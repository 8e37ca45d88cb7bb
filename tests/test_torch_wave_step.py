"""The port's all-sources bottleneck DP, region stats and wave step
(aletsch_tpu_torch/ops/bridge_dp.py, ops/coverage.py, parallel/mesh.py,
graft_entry.py) against the JAX package's functions (XLA on the CPU) and
the numpy oracles, on the same seeded inputs.  Tolerances: bottleneck
tables, the step's bottleneck, mx, sim and support are exact (min and max
only; integral counts; sums in one fixed order); ave, dev and region_stats
are sums whose order differs between numpy, XLA and PyTorch, held to
rtol = atol = 1e-6."""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aletsch_tpu.ops import bridge_dp as ref_bridge_dp
from aletsch_tpu.ops import coverage as ref_coverage
from aletsch_tpu.parallel import mesh as ref_mesh
from aletsch_tpu.parallel import wave_extract as ref_extract
from aletsch_tpu_torch import graft_entry
from aletsch_tpu_torch.ops import bottleneck as port_bottleneck
from aletsch_tpu_torch.ops import bridge_dp, coverage
from aletsch_tpu_torch.ops.constants import NEG, POS
from aletsch_tpu_torch.parallel import mesh, wave_extract

NAMES = ("bottleneck", "ave", "dev", "mx", "sim", "support")
EXACT = {"bottleneck", "mx", "sim", "support"}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def _random_W(rng, B, V, density):
    W = np.triu(rng.uniform(0, 10, size=(B, V, V)).astype(np.float32), k=1)
    return W * (rng.uniform(size=W.shape) < density)


def test_sentinels_equal_reference():
    assert (bridge_dp.NEG, bridge_dp.POS) == (ref_bridge_dp.NEG,
                                              ref_bridge_dp.POS) == (NEG, POS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_initial_table_holds_the_oracle_sentinels(dtype):
    """POS on the diagonal and NEG elsewhere, the very values the oracles
    hold in that dtype (in f32, POS rounds to 999999984306749440)."""
    T = bridge_dp.initial_table(2, 5, dtype, "cpu").numpy()
    np_dtype = T.dtype.type
    want = np.full((2, 5, 5), np_dtype(NEG))
    for i in range(5):
        want[:, i, i] = np_dtype(POS)
    assert np.array_equal(T, want)
    if dtype == torch.float32:
        eye = np.eye(5, dtype=np.float32) * np.float32(POS - NEG) \
            + np.float32(NEG)
        assert np.array_equal(T[0], eye)    # the reference's arithmetic form


def test_bottleneck_host_vs_jax():
    W = _random_W(np.random.default_rng(0), 4, 12, 0.4)
    want = bridge_dp.bottleneck_all_sources_host(W)
    assert np.array_equal(want, ref_bridge_dp.bottleneck_all_sources_host(W))
    got = bridge_dp.bottleneck_all_sources(torch.from_numpy(W)).numpy()
    ref = np.asarray(ref_bridge_dp.get_bottleneck_fn()(W))
    assert got.dtype == np.float32
    assert np.array_equal(got, ref)
    assert np.array_equal(got, want.astype(np.float32))
    got64 = bridge_dp.bottleneck_all_sources(
        torch.from_numpy(W).double()).numpy()
    assert np.array_equal(got64, want)


@pytest.mark.parametrize("B,V,density,seed", [(1, 2, 1.0, 1), (3, 33, 0.2, 2),
                                              (8, 64, 0.1, 3),
                                              (5, 64, 0.6, 4)])
def test_bottleneck_all_sources_equals_oracle_and_kernel_form(B, V, density,
                                                              seed):
    W = _random_W(np.random.default_rng(seed), B, V, density)
    T = bridge_dp.bottleneck_all_sources(torch.from_numpy(W))
    assert np.array_equal(
        T.numpy(),
        bridge_dp.bottleneck_all_sources_host(W).astype(np.float32))
    # row 0 is the single-source table, positive form
    row0 = port_bottleneck.bottleneck_torch(torch.from_numpy(W), False)
    assert torch.equal(T[:, 0, :], row0)


def test_bottleneck_matches_graph_dp():
    """The DP agrees with the sequential splice-graph max-path DP."""
    from helpers import build_bundle, default_cfg, two_exon_recs
    from aletsch_tpu_torch.core.graph import SpliceGraph
    from aletsch_tpu_torch.core.graph_builder import GraphBuilder
    bb = build_bundle(two_exon_recs())
    gr = SpliceGraph()
    GraphBuilder(bb, default_cfg()).build(gr)
    W = bridge_dp.dense_adjacency(gr)[None, :, :]
    assert np.array_equal(W[0], ref_bridge_dp.dense_adjacency(gr))
    T = bridge_dp.bottleneck_all_sources(torch.from_numpy(W)).numpy()
    w, p = gr.compute_maximum_path_w()
    assert T[0, 0, gr.num_vertices() - 1] == pytest.approx(w)
    padded = bridge_dp.dense_adjacency(gr, V=gr.num_vertices() + 3)
    assert np.array_equal(padded, ref_bridge_dp.dense_adjacency(
        gr, V=gr.num_vertices() + 3))


def test_bottleneck_vs_exhaustive_paths():
    """Pin the max-min semiring DP against brute-force path enumeration on
    tiny random DAGs (all sources, all targets)."""
    rng = np.random.default_rng(123)
    for trial in range(25):
        V = int(rng.integers(3, 7))
        W = np.triu(rng.uniform(1, 9, (1, V, V)).astype(np.float32), 1)
        W *= (rng.uniform(size=W.shape) < 0.6)
        got = bridge_dp.bottleneck_all_sources(torch.from_numpy(W))[0].numpy()

        def paths(s, t):
            if s == t:
                yield []
                return
            for m in range(s + 1, t + 1):
                if W[0, s, m] > 0:
                    for rest in paths(m, t):
                        yield [(s, m)] + rest

        for s, t in itertools.permutations(range(V), 2):
            best = max((min(W[0, a, b] for a, b in pth)
                        for pth in paths(s, t) if pth), default=None)
            if best is None:
                assert got[s, t] == np.float32(NEG), (trial, s, t)
            else:
                assert got[s, t] == best, (trial, s, t, got[s, t], best)


def test_region_stats_match_coverage_map():
    from aletsch_tpu_torch.utils.intervals import CoverageMap
    m = CoverageMap()
    m.add(0, 10, 2)
    m.add(20, 30, 4)
    l, r, v = m.contained(0, 30)
    S = 8
    vals = np.zeros((1, S))
    lens = np.zeros((1, S))
    mask = np.zeros((1, S))
    vals[0, :len(v)] = v
    lens[0, :len(v)] = (r - l)
    mask[0, :len(v)] = 1
    span = np.array([30.0])
    a2, d2, m2 = m.evaluate_rectangle(0, 30)
    for got in (coverage.region_stats_host(vals, lens, mask, span),
                [t.numpy() for t in coverage.region_stats(
                    *coverage.batch_from_numpy(vals, lens, mask, span,
                                               "cpu"))]):
        assert got[0][0] == pytest.approx(a2)
        assert got[1][0] == pytest.approx(d2)
        assert got[2][0] == pytest.approx(m2)


@pytest.mark.parametrize("R,S,seed", [(1, 4, 0), (37, 16, 1), (1024, 16, 2)])
def test_region_stats_equal_oracle_and_jax(R, S, seed):
    """f64 against the numpy oracle (the reference's, value for value) and
    f32 against the JAX function, with empty and zero-span regions."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 500, size=(R, S)).astype(np.float64)
    lens = rng.integers(1, 300, size=(R, S)).astype(np.float64)
    mask = (rng.random((R, S)) < 0.7).astype(np.float64)
    span = (lens * mask).sum(axis=1) + rng.integers(0, 100, R)
    mask[::5] = 0.0                 # empty regions: ave 0, dev 1, mx 0
    span[::7] = 0.0                 # zero span: ave 0, dev 0
    want = coverage.region_stats_host(vals, lens, mask, span)
    for w, r in zip(want, ref_coverage.region_stats_host(vals, lens, mask,
                                                         span)):
        assert np.array_equal(w, r)
    got = [t.numpy() for t in coverage.region_stats(
        *coverage.batch_from_numpy(vals, lens, mask, span, "cpu"))]
    assert all(g.dtype == np.float64 for g in got)
    assert np.allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert np.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[2], want[2])
    assert np.all(got[1][::5] == 1.0) and np.all(got[0][::5] == 0.0)
    f32 = [a.astype(np.float32) for a in (vals, lens, mask, span)]
    ref = [np.asarray(o) for o in ref_coverage.get_region_stats_fn()(*f32)]
    got32 = [t.numpy() for t in coverage.region_stats(
        *coverage.batch_from_numpy(*f32, "cpu", dtype=torch.float32))]
    assert all(g.dtype == np.float32 for g in got32)
    # f32 sums of up to 16 products of magnitude 1e5: a few ulps of the sum
    assert np.allclose(got32[0], ref[0], rtol=1e-6, atol=1e-6)
    assert np.allclose(got32[1], ref[1], rtol=1e-5, atol=1e-5)
    assert np.array_equal(got32[2], ref[2])


def _assert_step(tensors):
    """The port's step == jax.jit(_step_impl) == the numpy oracle."""
    want = wave_extract.host_oracle(*tensors)
    ref = [np.asarray(o) for o in jax.jit(ref_mesh._step_impl(jnp, jax))(
        *(jnp.asarray(a) for a in tensors))]
    got = mesh.outputs_to_numpy(mesh.step(*mesh.batch_from_numpy(*tensors,
                                                                 "cpu")))
    assert len(got) == 6
    for name, g, r, w in zip(NAMES, got, ref, want):
        assert g.dtype == np.float32 and g.flags["C_CONTIGUOUS"], name
        assert g.shape == r.shape == w.shape, name
        if name in EXACT:
            assert np.array_equal(g, r), "%s != the JAX step's" % name
            assert np.array_equal(g, w), "%s != the oracle's" % name
        else:
            assert np.allclose(g, r, rtol=1e-6, atol=1e-6), name
            assert np.allclose(g, w, rtol=1e-6, atol=1e-6), name
    return got


@pytest.mark.parametrize("shape", [
    dict(), dict(B=16, V=16, S=8, P_=32, Ns=2, J=8),
    dict(B=5, V=64, S=16, P_=128, Ns=2, J=64, seed=3)])
def test_step_equals_jax_and_oracle_on_example_batch(shape):
    args = mesh.example_batch(**shape)
    for a, r in zip(args, ref_mesh.example_batch(**shape)):
        assert a.dtype == r.dtype and np.array_equal(a, r)
    bottleneck, ave, dev, mx, sim, support = _assert_step(args)
    assert np.allclose(support, args[6].sum(axis=0), rtol=1e-5)
    assert np.allclose(sim, args[5] @ args[5].T, rtol=1e-5)


def test_step_support_is_exact_over_ten_samples():
    """Ten samples of non-integral weights: the sample-axis sum adds in
    the samples' order, as numpy does, so it equals the oracle's bit for
    bit (XLA's order over ten terms is its own: not compared here)."""
    args = mesh.example_batch(B=64, V=64, S=16, P_=128, Ns=10, J=64)
    want = wave_extract.host_oracle(*args)
    got = mesh.outputs_to_numpy(mesh.step(*mesh.batch_from_numpy(*args,
                                                                 "cpu")))
    for name, g, w in zip(NAMES, got, want):
        if name in EXACT:
            assert np.array_equal(g, w), name
        else:
            assert np.allclose(g, w, rtol=1e-6, atol=1e-6), name


def _cohort_params(tmp_path, default_params, simulate_sample, sub):
    lines = []
    for i, seed in enumerate((41, 42)):
        bam = str(tmp_path / ("%s_s%d.bam" % (sub, i)))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = tmp_path / (sub + "_bams.list")
    lst.write_text("".join(lines))
    out = tmp_path / sub
    (out / "gtf").mkdir(parents=True)
    params = default_params()
    for p in params:
        p.input_bam_list = str(lst)
        p.output_gtf_file = str(out / "meta.gtf")
        p.output_gtf_dir = str(out / "gtf")
        p.verbose = 0
    return params, out


def test_real_wave_step_equals_oracle(tmp_path):
    """Tensors captured from the two-sample cohort by each package's own
    pipeline are equal, and the port's step on them == the JAX step == the
    oracle (exact for the order-free outputs, 1e-6 for ave and dev)."""
    from aletsch_tpu.config import default_params as ref_params
    from aletsch_tpu.sim import simulate_sample as ref_simulate
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.sim import simulate_sample
    shape = dict(B=8, V=32, S=16, P_=64, Ns=2, J=16)
    params, _ = _cohort_params(tmp_path, default_params, simulate_sample,
                               "port")
    tensors, info = wave_extract.capture_cohort_tensors(params, **shape)
    rparams, _ = _cohort_params(tmp_path, ref_params, ref_simulate, "ref")
    rtensors, rinfo = ref_extract.capture_cohort_tensors(rparams, **shape)
    assert info == rinfo
    assert info["groups"] >= 2 and info["samples"] == 2
    assert info["junctions"] >= 1, "no cross-sample junction support"
    for a, r in zip(tensors, rtensors):
        assert a.dtype == r.dtype and np.array_equal(a, r)
    assert (tensors[6] != 0).any(axis=(1, 2)).all(), \
        "a sample contributed no junction weight"
    for w, r in zip(wave_extract.host_oracle(*tensors),
                    ref_extract.host_oracle(*tensors)):
        assert np.array_equal(w, r)
    sim = _assert_step(tensors)[4]
    # the product sees the real splice sets: each group's self-intersection
    # equals its splice count
    assert np.array_equal(np.diag(sim), tensors[5].sum(axis=1))
    assert np.diag(sim).max() >= 2.0, "no real splice set reached sim"


def test_capture_is_transparent(tmp_path):
    """The extraction hook must not perturb the port's pipeline: outputs
    with and without capture are byte-identical."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.meta.incubator import Incubator
    from aletsch_tpu_torch.sim import simulate_sample
    outs = []
    for sub, capture in (("plain", False), ("captured", True)):
        params, out = _cohort_params(tmp_path, default_params,
                                     simulate_sample, sub)
        if capture:
            wave_extract.capture_cohort_tensors(params, B=8, V=32, S=16,
                                                P_=64, Ns=2, J=16)
        else:
            Incubator(params).resolve()
        files = {"meta.gtf": (out / "meta.gtf").read_bytes()}
        for f in sorted(os.listdir(out / "gtf")):
            files[f] = (out / "gtf" / f).read_bytes()
        outs.append(files)
    assert outs[0] == outs[1] and len(outs[0]) > 1


def test_graft_entry():
    """entry() gives the step and its example arguments on the port's
    device; its outputs equal the JAX entry point's step on the same
    batch."""
    fn, args = graft_entry.entry()
    assert all(a.device.type == "cpu" and a.dtype == torch.float32
               for a in args)
    out = fn(*args)
    assert len(out) == 6
    assert [tuple(o.shape) for o in out] == [(8,)] * 4 + [(8, 8), (8, 16)]
    _assert_step(ref_mesh.example_batch(B=8, V=32))
    for a, r in zip(args, ref_mesh.example_batch(B=8, V=32)):
        assert np.array_equal(a.numpy(), r)
