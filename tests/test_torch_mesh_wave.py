"""The port's incubator with its live wave batches split over emulated
devices (ops/meshing.py), against the host path, on the CPU: the port's
counterparts of tests/test_mesh_production.py and
tests/test_mesh_wave.py::test_all_device_paths_transcript_equality.  The
fused drain, bridge top-K, support reduce and ladder batches of every wave
split over n CPU devices (each chunk solved on its own, the rows joined in
order) must leave every output byte-identical to the host path, with the
mesh's dispatches and bytes accounted."""

import os

import pytest
import torch

from aletsch_tpu_torch.config import default_params
from aletsch_tpu_torch.meta import device_wave
from aletsch_tpu_torch.meta.incubator import Incubator
from aletsch_tpu_torch.ops import meshing
from torch_helpers import output_bytes

needs_native = pytest.mark.skipif(
    os.environ.get("ALETSCH_NATIVE_CORE") == "0",
    reason="device path requires the native core")

STAGES = ("greedy", "bridge", "support", "ladder", "similarity")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cohort(base, simulate, seeds, **kw):
    lines = []
    for i, seed in enumerate(seeds):
        bam = str(base / ("s%d.bam" % i))
        simulate(bam, seed=seed, **kw)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    return str(lst)


def _run(lst, out, on, max_num_exons=8):
    """The incubator in process with the stages in `on` forced onto the
    device (the others off); returns every output file's bytes."""
    (out / "gtf").mkdir(parents=True)
    params = default_params()
    for p in params:
        p.input_bam_list = lst
        p.output_gtf_file = str(out / "meta.gtf")
        p.output_gtf_dir = str(out / "gtf")
        p.verbose = 0
        if max_num_exons is not None:
            p.max_num_exons = max_num_exons
        for s in STAGES:
            setattr(p, "device_" + s, "on" if s in on else "off")
        if on:
            p.device_min_vertices = 2
            p.device_min_groups = 0
    Incubator(params).resolve()
    return output_bytes(str(out / "meta.gtf"), str(out / "gtf"))


@pytest.fixture(scope="module")
def adversarial(tmp_path_factory):
    """tests/test_mesh_production.py's cohort and its host bytes."""
    from aletsch_tpu_torch.sim import simulate_adversarial_sample
    base = tmp_path_factory.mktemp("adversarial")
    lst = _cohort(base, simulate_adversarial_sample, (31, 32), n_loci=8)
    return lst, _run(lst, base / "host", ())


@needs_native
@pytest.mark.parametrize("n,stages", [
    (2, ("greedy", "bridge", "support", "ladder")),
    (3, ("greedy", "bridge", "support", "ladder")),
    (8, ("greedy", "bridge", "support"))], ids=["2", "3", "8"])
def test_incubator_wave_runs_sharded_and_byte_identical(adversarial, n,
                                                        stages, tmp_path,
                                                        monkeypatch):
    """The device stages on over n emulated devices (3: most batches do
    not divide and run replicated; 8: the JAX package's test, whose stages
    leave the ladder on the host): byte-identical, and the live batches of
    every stage that dispatched moved over the mesh (the support reduce
    finds no group on this cohort)."""
    lst, host = adversarial
    monkeypatch.setattr(meshing, "_local_devices",
                        lambda device: [torch.device("cpu")] * n)
    device_wave.reset_solvers()
    got = _run(lst, tmp_path / "on", stages)
    assert got == host, "sharded device wave diverged from host bytes"
    d = device_wave.device_stats()
    assert d["mesh_devices"] == n
    assert d["fused_graphs"] > 0 and d["bridge_instances"] > 0
    assert (d.get("ladder_graphs", 0) > 0) == ("ladder" in stages)
    solvers = [device_wave._FUSED, device_wave._BRIDGE]
    if "ladder" in stages:
        solvers.append(device_wave._LADDER)
    for solver in solvers:
        st = solver.stats
        assert st["mesh_devices"] == n
        assert st["mesh_dispatches"] > 0
        assert st["mesh_bytes_in"] > 0 and st["mesh_bytes_out"] > 0


@needs_native
def test_all_device_paths_transcript_equality(tmp_path, monkeypatch):
    """tests/test_mesh_wave.py's 2-sample cohort over 8 emulated devices:
    the drain, the bridge DP, the support reduce and the similarity product
    ALL on the device reproduce the host bytes."""
    from aletsch_tpu_torch.ops import similarity
    from aletsch_tpu_torch.sim import simulate_sample
    lst = _cohort(tmp_path, simulate_sample, (41, 42))
    host = _run(lst, tmp_path / "host", (), max_num_exons=None)
    monkeypatch.setattr(meshing, "_local_devices",
                        lambda device: [torch.device("cpu")] * 8)
    device_wave.reset_solvers()
    monkeypatch.setattr(similarity, "_DEVICE_THRESHOLD", 2)
    b0 = dict(device_wave.stats)
    got = _run(lst, tmp_path / "device", ("greedy", "bridge", "support",
                                          "similarity"), max_num_exons=None)
    assert got == host
    d = device_wave.device_stats()
    for key in ("device_bridge_insts", "device_support_groups"):
        assert d[key] > b0[key], key
    assert d["similarity_sparse"] > 0
    assert d["mesh_devices"] == 8 and d["mesh_dispatches"] > 0
