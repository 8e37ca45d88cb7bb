"""The port's device mesh (ops/meshing.py, parallel/mesh.py,
parallel/scaling.py, graft_entry.py) against the JAX package's, on the CPU.

The JAX package's tests run on a virtual 8-device CPU mesh
(tests/conftest.py).  The port emulates n devices with a list of n CPU
devices, handed to make_mesh or put in place of
ops/meshing.py::_local_devices: the same code that splits a batch over n
cards then runs every chunk on the CPU.  The sharded step must equal the
single-device step and the numpy host oracle (exact on bottleneck, mx, sim
and the 2-sample support, 1e-6 on ave and dev) and the JAX package's
sharded step; every wave solver must give the one-device rows over 2 and 3
emulated devices; and the mesh accounting must equal the JAX package's."""

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import meshing as ref_meshing
from aletsch_tpu.parallel import mesh as ref_mesh
from aletsch_tpu.parallel import scaling as ref_scaling
from aletsch_tpu_torch import graft_entry
from aletsch_tpu_torch.ops import bridge_topk, crossover, greedy_fused
from aletsch_tpu_torch.ops import ladder_kernel, meshing, support
from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
from aletsch_tpu_torch.parallel import mesh, scaling
from aletsch_tpu_torch.parallel.wave_extract import (capture_cohort_tensors,
                                                     host_oracle)

CPU = torch.device("cpu")
NAMES = ("bottleneck", "ave", "dev", "mx", "sim", "support")
EXACT = {"bottleneck", "mx", "sim", "support"}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def emulate(monkeypatch, n):
    """Make the port see n local devices, all of them the CPU."""
    monkeypatch.setattr(meshing, "_local_devices", lambda device: [CPU] * n)


def _check_outputs(want, got, tag):
    for name, w, g in zip(NAMES, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert w.shape == g.shape, (tag, name)
        if name in EXACT:
            assert np.array_equal(w, g), (tag, name)
        else:
            assert np.allclose(w, g, rtol=1e-6, atol=1e-6), (tag, name)


# ------------------------------------------------------------ ops/meshing

@pytest.mark.parametrize("n,rows", [(1, 8), (2, 8), (8, 8), (3, 8),
                                    (2, 5)])
def test_shard_args_splits_rows_or_replicates(monkeypatch, n, rows):
    """n devices: rows that divide by n split into n chunks in order, one a
    device; others go whole to every device; one device is a passthrough
    with no copy and no stats."""
    emulate(monkeypatch, n)
    a = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
    b = torch.arange(rows, dtype=torch.int32)
    stats = {}
    shards, split = meshing.shard_args([a, b], stats, CPU)
    if n == 1:
        assert len(shards) == 1 and split is False
        assert shards[0][0] == CPU
        assert shards[0][1][0] is a and shards[0][1][1] is b
        assert stats == {}
        meshing.account_out((a,), stats, CPU)
        assert stats == {}
        return
    assert len(shards) == n and split == (rows % n == 0)
    for k, t in enumerate((a, b)):
        got = [args[k] for _, args in shards]
        if split:
            assert torch.equal(torch.cat(got), t)
            assert {g.shape[0] for g in got} == {rows // n}
        else:
            assert all(torch.equal(g, t) for g in got)
    parts = [tuple(g.numpy() for g in args) for _, args in shards]
    joined = meshing.join_rows(parts, split)
    assert np.array_equal(joined[0], a.numpy())
    assert np.array_equal(joined[1], b.numpy())
    assert all(j.flags["C_CONTIGUOUS"] for j in joined)
    assert stats == {"mesh_devices": n, "mesh_dispatches": 1,
                     "mesh_bytes_in": a.nbytes + b.nbytes}


@pytest.mark.parametrize("rows", [64, 63])
def test_mesh_accounting_equals_the_jax_package(monkeypatch, rows):
    """The same wave arrays through the JAX package's shard_args on its
    8-device mesh and the port's on 8 emulated devices: the same stats."""
    rng = np.random.default_rng(rows)
    batched = [rng.random((rows, 4, 4)),
               rng.integers(0, 9, size=rows).astype(np.int32)]
    outs = [rng.random((rows, 2)).astype(np.float32)]
    assert ref_meshing.get_mesh() is not None
    want = {}
    ref_meshing.shard_args(batched, [], want)
    ref_meshing.account_out(outs, want)
    emulate(monkeypatch, 8)
    got = {}
    meshing.shard_args([torch.from_numpy(a) for a in batched], got, CPU)
    meshing.account_out(outs, got, CPU)
    assert got == want
    assert set(got) == {"mesh_devices", "mesh_dispatches", "mesh_bytes_in",
                        "mesh_bytes_out"}


def _drain_solver(B):
    W, P, sink, scal = crossover.synth_batch(B, 32, seed=9, n_vertices=20)
    s = greedy_fused.DeviceGreedyFused(batch=B, maxv=32, maxp=16, device=CPU)
    s.W[...], s.P[...], s.sink[...], s.scal[...] = W, P, sink, scal
    return s


def _bridge_solver(B):
    s = bridge_topk.DeviceBridge(batch=B, maxv=16, maxe=4, maxt=4,
                                 device=CPU)
    for arr, src in zip((s.P, s.Wt, s.Lv, s.tgt), bridge_topk.fuzz_batch(
            np.random.default_rng(4), B, 16, 4, 4, ties=True)):
        arr[...] = src
    return s


def _support_solver(B):
    s = support.DeviceSupport(batch=B, maxs=4, maxj=16, device=CPU)
    s.jw[...] = np.random.default_rng(6).integers(
        0, 50, size=s.jw.shape).astype(np.float32)
    return s


def _ladder_solver(B):
    shape = dict(V=24, E=96, H=16, L=16)
    _, states = ladder_kernel.fuzz_states(range(B), **shape)
    s = DeviceLadder(batch=B, maxv=24, maxe=96, maxh=16, maxl=16, dmax=12,
                     dlog=64, device=CPU)
    s.stage_states(ladder_kernel.pack_states(states, B, **shape), B)
    return s


SOLVERS = {"drain": _drain_solver, "bridge": _bridge_solver,
           "support": _support_solver, "ladder": _ladder_solver}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_solvers_split_over_emulated_devices(monkeypatch, solver, n):
    """Each wave solver over n emulated devices gives the one-device rows
    exactly (split where the rows divide by n, replicated where not), as
    C-contiguous host arrays, and accounts the mesh."""
    nrows = 6
    want = SOLVERS[solver](8).solve(nrows)
    emulate(monkeypatch, n)
    s = SOLVERS[solver](8)
    got = s.solve(nrows)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.flags["C_CONTIGUOUS"]
        assert np.array_equal(g, w)
    assert s.stats["mesh_devices"] == n
    assert s.stats["mesh_dispatches"] == 1
    assert s.stats["mesh_bytes_in"] > 0
    assert s.stats["mesh_bytes_out"] == sum(g.nbytes for g in got)


# ---------------------------------------------------------- parallel/mesh

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_axis_rule_equals_the_jax_package(n):
    got = mesh.make_mesh(n, devices=[CPU] * 8)
    want = ref_mesh.make_mesh(n)
    assert got.shape == dict(want.shape)
    assert got.size == want.size == n
    assert mesh.make_mesh(n, sample_axis=1, devices=[CPU] * 8).shape == \
        dict(ref_mesh.make_mesh(n, sample_axis=1).shape)


def test_make_mesh_reads_the_local_devices(monkeypatch):
    emulate(monkeypatch, 4)
    m = mesh.make_mesh()
    assert m.shape == {"data": 2, "sample": 2}
    assert [d for row in m.devices for d in row] == [CPU] * 4


@pytest.fixture(scope="module")
def wave(tmp_path_factory):
    """Tensors of the first region wave of a real 2-sample cohort
    (test_mesh_wave.py's capture), 8 groups."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.sim import simulate_sample
    base = tmp_path_factory.mktemp("wave")
    lines = []
    for i, seed in enumerate((41, 42)):
        bam = str(base / ("s%d.bam" % i))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    (base / "gtf").mkdir()
    params = default_params()
    for p in params:
        p.input_bam_list = str(lst)
        p.output_gtf_file = str(base / "meta.gtf")
        p.output_gtf_dir = str(base / "gtf")
        p.verbose = 0
    tensors, info = capture_cohort_tensors(params, B=8, V=32, S=16, P_=64,
                                           Ns=2, J=16)
    assert info["groups"] >= 2 and info["samples"] == 2
    assert info["junctions"] >= 1, "no cross-sample junction support"
    assert (tensors[6] != 0).any(axis=(1, 2)).all(), \
        "a sample contributed no junction weight"
    return tensors


@pytest.mark.parametrize("n", [2, 4, 8])
def test_real_wave_sharded_equals_single_and_oracle(wave, n):
    """A real cohort wave through the step split over n emulated devices:
    equal to the one-device step, the numpy oracle and the JAX package's
    step split over its n-device mesh."""
    import jax
    m = mesh.make_mesh(n, devices=[CPU] * n)
    assert m.shape["data"] * m.shape["sample"] == n
    args = mesh.batch_from_numpy(*wave, CPU)
    single = mesh.outputs_to_numpy(mesh.step(*args))
    sharded = mesh.outputs_to_numpy(mesh.build_sharded_step(m)(*args))
    _check_outputs(single, sharded, "single")
    _check_outputs(host_oracle(*wave), sharded, "oracle")
    jax_sharded = ref_mesh.build_sharded_step(ref_mesh.make_mesh(n))(
        *(jax.numpy.asarray(a) for a in wave))
    _check_outputs(jax_sharded, sharded, "jax")
    # the similarity product sees the real splice sets: each group's
    # self-intersection is its splice count
    sim, inc = sharded[4], wave[5]
    assert np.array_equal(np.diag(sim), inc.sum(axis=1))
    assert np.diag(sim).max() >= 2.0, "no real splice set reached sim"


def test_sharded_step_8dev():
    """tests/test_ops_parallel.py's example batch over 8 emulated devices:
    the output shapes, the sample-axis sum and the similarity product."""
    m = mesh.make_mesh(8, devices=[CPU] * 8)
    host = mesh.example_batch(B=16, V=16, S=8, P_=32, Ns=2, J=8)
    out = mesh.outputs_to_numpy(mesh.build_sharded_step(m)(
        *mesh.batch_from_numpy(*host, CPU)))
    bottleneck, ave, dev, mx, sim, sup = out
    assert bottleneck.shape == (16,) and sim.shape == (16, 16)
    assert sup.shape == (16, 8)
    assert np.array_equal(sup, host[6].sum(axis=0))
    assert np.array_equal(sim, host[5] @ host[5].T)
    _check_outputs(host_oracle(*host), out, "oracle")


def test_sharded_step_refuses_an_uneven_split():
    m = mesh.make_mesh(8, devices=[CPU] * 8)           # 4 data shards
    args = mesh.batch_from_numpy(*mesh.example_batch(B=6, V=8), CPU)
    with pytest.raises(ValueError, match="does not split"):
        mesh.build_sharded_step(m)(*args)


def test_capture_is_transparent(tmp_path):
    """The extraction hook does not perturb the pipeline: outputs with and
    without capture are byte-identical."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.meta.incubator import Incubator
    from aletsch_tpu_torch.sim import simulate_sample
    from torch_helpers import output_bytes
    lines = []
    for i, seed in enumerate((41, 42)):
        bam = str(tmp_path / ("s%d.bam" % i))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = tmp_path / "bams.list"
    lst.write_text("".join(lines))
    outs = []
    for sub in ("plain", "captured"):
        out = tmp_path / sub
        (out / "gtf").mkdir(parents=True)
        params = default_params()
        for p in params:
            p.input_bam_list = str(lst)
            p.output_gtf_file = str(out / "meta.gtf")
            p.output_gtf_dir = str(out / "gtf")
            p.verbose = 0
        if sub == "plain":
            Incubator(params).resolve()
        else:
            capture_cohort_tensors(params, B=8, V=32, S=16, P_=64, Ns=2,
                                   J=16)
        outs.append(output_bytes(str(out / "meta.gtf"), str(out / "gtf")))
    assert outs[0] == outs[1]


# ------------------------------------------------------ parallel/scaling

def test_scaling_over_emulated_devices(monkeypatch):
    """measure_scaling and measure_scaling_shape run the sharded step over
    1, 2 and 4 emulated devices; format_scaling prints what the JAX
    package's prints."""
    emulate(monkeypatch, 4)
    res = scaling.measure_scaling(B_per_dev=2, V=8, reps=1)
    assert [r[0] for r in res] == [1, 2, 4]
    assert res[0][3] == 1.0 and all(r[1] > 0 and r[2] > 0 for r in res)
    assert scaling.format_scaling(res) == ref_scaling.format_scaling(res)
    shape = scaling.measure_scaling_shape([1, 2], B_per_dev=4, V=8, reps=1)
    rows = shape["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["total_batch"] for r in rows] == [4, 8]
    assert rows[1]["bytes_in_per_device"] == sum(
        a.nbytes for a in mesh.example_batch(B=8, V=8, Ns=2)) // 2
    assert all(len(r["mesh_vs_single_rounds"]) == 3 for r in rows)
    assert set(shape) == {"rows", "pure_host_contention", "window_unstable",
                          "largest_mesh_vs_single", "note"}


# ----------------------------------------------------------- graft_entry

def test_graft_entry():
    fn, args = graft_entry.entry()
    out = fn(*args)
    assert [tuple(o.shape) for o in out] == [(8,), (8,), (8,), (8,),
                                             (8, 8), (8, 16)]
    assert all(o.device == CPU for o in out)


@pytest.mark.parametrize("n", [1, 8])
def test_dryrun_multichip_runs(monkeypatch, n):
    """The dry run (real tensors, parity asserts, then the pipeline with
    every device stage on) passes over n emulated devices; over 8 the wave
    solvers' batches split over them."""
    from aletsch_tpu_torch.meta import device_wave
    emulate(monkeypatch, n)
    device_wave.reset_solvers()
    graft_entry.dryrun_multichip(n)
    assert device_wave.device_stats().get("mesh_devices") == \
        (n if n > 1 else None)


def test_dryrun_asks_for_the_devices_it_names(monkeypatch):
    """Over fewer local devices than it names, the dry run fails."""
    from aletsch_tpu_torch.meta import device_wave
    emulate(monkeypatch, 2)
    device_wave.reset_solvers()
    with pytest.raises(AssertionError, match="not sharded over 4"):
        graft_entry.dryrun_multichip(4)


def test_graft_entry_module_runs_as_a_script(tmp_path):
    import subprocess
    import sys
    from torch_helpers import REPO, blocked_env
    res = subprocess.run([sys.executable, "-m",
                          "aletsch_tpu_torch.graft_entry"], cwd=REPO,
                         env=blocked_env(str(tmp_path / "shim")),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "dryrun ok"
