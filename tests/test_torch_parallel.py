"""The port's multi-process execution (parallel/{jobs,worker,distributed}.py
and the incubator's profile workers) against the JAX package, on the CPU
device: region shards merged, --jobs N and subprocess-profiled samples give
the one-process bytes, with jax and the JAX package unimportable in every
process the run spawns (tests/torch_helpers.py), and a worker that never
engages the card imports no torch.  Also a scan that no port source
spawns the JAX package by name (--jax_dist: tests/test_torch_jaxdist.py)."""

import os
import pickle
import re
import subprocess
import sys

import pytest

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.config import default_params
from aletsch_tpu_torch.meta import incubator as port_incubator
from aletsch_tpu_torch.meta.incubator import Incubator
from aletsch_tpu_torch.parallel.distributed import (merge_shards,
                                                    run_region_shard)
from aletsch_tpu_torch.parallel.jobs import run_parallel
from test_distributed import make_cohort
from torch_helpers import REPO, blocked_env, output_bytes

FORCED = ["--device_greedy", "on", "--device_min_vertices", "2",
          "--device_min_groups", "0", "--max_num_exons", "8",
          "--verbose", "0"]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def make_params(bl, region_len, out_gtf, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    params = default_params()
    for p in params:
        p.input_bam_list = bl
        p.output_gtf_file = out_gtf
        p.output_gtf_dir = out_dir
        p.region_partition_length = region_len   # force many regions
        p.verbose = 0
    return params


@pytest.fixture(scope="module")
def adversarial(tmp_path_factory):
    """The cohort of tests/test_torch_e2e.py, whose graphs reach the drain,
    and the JAX package's bytes on it with the device off."""
    from aletsch_tpu.sim import simulate_adversarial_sample
    base = tmp_path_factory.mktemp("adversarial")
    lines = []
    for i, seed in enumerate((21, 22)):
        bam = str(base / ("s%d.bam" % i))
        simulate_adversarial_sample(bam, seed=seed, n_loci=10)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    out = base / "ref"
    (out / "gtf").mkdir(parents=True)
    assert ref_main.main(["-i", str(lst), "-o", str(out / "meta.gtf"), "-d",
                          str(out / "gtf"), *FORCED, "--device_greedy",
                          "off"]) == 0
    return str(lst), output_bytes(str(out / "meta.gtf"), str(out / "gtf"))


def _port_cli(lst, out, env, *flags):
    """python -m aletsch_tpu_torch as a subprocess; returns its stderr."""
    os.makedirs(os.path.join(out, "gtf"))
    res = subprocess.run(
        [sys.executable, "-m", "aletsch_tpu_torch", "-i", lst, "-o",
         os.path.join(out, "meta.gtf"), "-d", os.path.join(out, "gtf"),
         *flags], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stderr


def test_two_shards_equal_single_host(tmp_path):
    bl, region_len = make_cohort(tmp_path)
    params1 = make_params(bl, region_len, str(tmp_path / "single.gtf"),
                          str(tmp_path / "single_gtf"))
    inc1 = Incubator(params1)
    inc1.resolve()
    dumps = []
    shard_stats_bundles = 0
    for h in range(2):
        params_h = make_params(bl, region_len, str(tmp_path / "unused.gtf"),
                               str(tmp_path / "unused_dir"))
        d = str(tmp_path / ("shard%d.pkl" % h))
        inc = run_region_shard(params_h, h, 2, d)
        shard_stats_bundles += inc.stats["bundles"]
        dumps.append(d)
    paramsm = make_params(bl, region_len, str(tmp_path / "merged.gtf"),
                          str(tmp_path / "merged_gtf"))
    merge_shards(paramsm, dumps)
    # shard workloads were disjoint and complete
    assert shard_stats_bundles == inc1.stats["bundles"] > 0
    assert output_bytes(str(tmp_path / "single.gtf"),
                        str(tmp_path / "single_gtf")) == \
        output_bytes(str(tmp_path / "merged.gtf"),
                     str(tmp_path / "merged_gtf"))


def test_parallel_jobs_equal_single(tmp_path, monkeypatch):
    """run_parallel with 1 and 2 jobs, the workers spawned with jax and the
    JAX package unimportable (and torch too: nothing engages the card)."""
    bl, region_len = make_cohort(tmp_path, n_samples=2, n_genes=5)
    env = blocked_env(str(tmp_path / "shim"),
                      blocked=("jax", "aletsch_tpu", "torch"))
    monkeypatch.setenv("PYTHONPATH", env["PYTHONPATH"])
    params1 = make_params(bl, region_len, str(tmp_path / "j1.gtf"),
                          str(tmp_path / "j1_gtf"))
    run_parallel(params1, 1)
    params2 = make_params(bl, region_len, str(tmp_path / "j2.gtf"),
                          str(tmp_path / "j2_gtf"))
    run_parallel(params2, 2)
    one = output_bytes(str(tmp_path / "j1.gtf"), str(tmp_path / "j1_gtf"))
    assert one == output_bytes(str(tmp_path / "j2.gtf"),
                               str(tmp_path / "j2_gtf"))
    assert one["meta.gtf"].count(b"\ttranscript\t") > 0


def test_jobs_cli_with_the_drain_forced(adversarial, tmp_path):
    """--jobs 2 with the drain forced: each worker engages the device path
    (plain PyTorch on the CPU device) and the bytes are the reference's."""
    lst, ref = adversarial
    out = str(tmp_path / "jobs")
    _port_cli(lst, out, blocked_env(str(tmp_path / "shim")), *FORCED,
              "--jobs", "2")
    assert output_bytes(os.path.join(out, "meta.gtf"),
                        os.path.join(out, "gtf")) == ref


def test_shard_cli_round(adversarial, tmp_path):
    """--shard 0 2 / --shard 1 2 with the drain forced, then
    --merge_shards with torch unimportable (a merge engages nothing)."""
    lst, ref = adversarial
    env = blocked_env(str(tmp_path / "shim"))
    dumps = []
    for h in range(2):
        dumps.append(str(tmp_path / ("shard%d.pkl" % h)))
        _port_cli(lst, str(tmp_path / ("s%d" % h)), env, *FORCED,
                  "--shard", str(h), "2", "--shard_dump", dumps[-1])
    out = str(tmp_path / "merged")
    _port_cli(lst, out, blocked_env(str(tmp_path / "shim_no_torch"),
                                    blocked=("jax", "aletsch_tpu", "torch")),
              *FORCED, "--merge_shards", ",".join(dumps))
    assert output_bytes(os.path.join(out, "meta.gtf"),
                        os.path.join(out, "gtf")) == ref


@pytest.mark.parametrize("env", [{"ALETSCH_DEVICE": "0"}, {}],
                         ids=["ALETSCH_DEVICE=0", "defaults"])
@pytest.mark.parametrize("jobs", [1, 2])
def test_cli_runs_with_torch_blocked(adversarial, tmp_path, env, jobs):
    """With ALETSCH_DEVICE=0, and at the CLI's defaults on the CPU device
    ('auto' answers no from the device's name), no process of the run
    imports torch, and the bytes are the reference's."""
    lst, ref = adversarial
    out = str(tmp_path / "out")
    err = _port_cli(lst, out, blocked_env(
        str(tmp_path / "shim"), blocked=("jax", "aletsch_tpu", "torch"),
        **env), "--max_num_exons", "8", "--verbose", "1",
        *(["--jobs", "2"] if jobs > 1 else []))
    assert output_bytes(os.path.join(out, "meta.gtf"),
                        os.path.join(out, "gtf")) == ref
    if jobs == 1:
        line = [ln for ln in err.splitlines()
                if ln.startswith("[aletsch_tpu_torch] device:")][-1]
        assert "'fused_graphs'" not in line and "'drain_launches': 0" in line
        assert ("'asked'" in line) == (not env)


def test_profile_workers_equal_threads(tmp_path, monkeypatch):
    """_prep_samples_subprocess (parallel/worker.py profile, the route the
    incubator takes for large inputs without the native core) gives the
    profiles _prep_sample gives in process; the workers import neither
    jax, the JAX package nor torch."""
    bl, region_len = make_cohort(tmp_path, n_samples=2, n_genes=3)
    env = blocked_env(str(tmp_path / "shim"),
                      blocked=("jax", "aletsch_tpu", "torch"))
    monkeypatch.setenv("PYTHONPATH", env["PYTHONPATH"])
    params = make_params(bl, region_len, str(tmp_path / "p.gtf"),
                         str(tmp_path / "p_gtf"))
    inc = Incubator(params)
    inc.read_bam_list()
    inc.build_sample_index()
    want = [pickle.dumps(port_incubator._prep_sample(
        (pickle.loads(pickle.dumps(sp)), params))) for sp in inc.samples]
    got = port_incubator._prep_samples_subprocess(params, inc.samples, 2)
    assert [pickle.dumps(sp) for sp in got] == want


def test_shard_needs_a_dump_path(capsys):
    assert port_main.main(["-i", "x.list", "-o", "x.gtf", "--shard", "0",
                           "2"]) == 1
    assert "--shard requires --shard_dump" in capsys.readouterr().out


# a module of the JAX package named in a string: what a subprocess would
# run with -m, or an import by name
SPAWN_BY_NAME = re.compile(
    r"""["']aletsch_tpu(?!_torch)(\.|["'])|-m\s+aletsch_tpu(?!_torch)""")


# the modules that spawn the package's processes -> what the port's copy
# spawns
SPAWNERS = {"parallel/jobs.py": '"aletsch_tpu_torch.parallel.worker"',
            "meta/incubator.py": '"aletsch_tpu_torch.parallel.worker"',
            "parallel/jaxdist.py": '"-m", "aletsch_tpu_torch"]'}


def test_sources_never_spawn_the_jax_package():
    """No source of the port names a module of the JAX package in a string
    (the import scan of tests/test_torch_e2e.py cannot see `python -m
    aletsch_tpu.parallel.worker` in a subprocess's argv); the copies spawn
    the port's own workers.  The scan finds the originals' spawns."""
    pkg = os.path.join(REPO, "aletsch_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                assert not SPAWN_BY_NAME.search(line), "%s:%d: %s" % (
                    path, n, line.strip())
    assert {os.path.join(pkg, rel) for rel in SPAWNERS} <= set(sources)
    for rel, spawned in SPAWNERS.items():
        with open(os.path.join(REPO, "aletsch_tpu", rel)) as fh:
            assert SPAWN_BY_NAME.search(fh.read()), rel
        with open(os.path.join(pkg, rel)) as fh:
            assert spawned in fh.read(), rel


@pytest.mark.parametrize("name", ["cpu", "cpu:0"])
def test_auto_answers_no_from_the_device_name(tmp_path, name):
    """On the CPU device 'auto' says no at every stage and size from
    ALETSCH_TORCH_DEVICE alone: the policy, the solvers and torch stay
    unloaded, and the device stats read without them."""
    code = "\n".join([
        "import sys",
        "from aletsch_tpu_torch.config import default_params",
        "from aletsch_tpu_torch.meta import device_wave as w",
        "cfg = default_params()[0]",
        "for stage in ('drain', 'bridge', 'support', 'ladder', "
        "'similarity'):",
        "    assert w.auto_device_ok(cfg, 4096, stage) is False, stage",
        "assert w.enabled(cfg, 4096) is False",
        "st = w.device_stats()",
        "assert st['auto']['calibrated'] is False",
        "assert st['drain_launches'] == st['bottleneck_launches'] == 0",
        "loaded = [m for m in sys.modules if m.startswith("
        "'aletsch_tpu_torch.ops.')]",
        "assert sorted(loaded) == ['aletsch_tpu_torch.ops.constants', "
        "'aletsch_tpu_torch.ops.similarity'], loaded"])
    env = blocked_env(str(tmp_path / "shim"),
                      blocked=("jax", "aletsch_tpu", "torch"),
                      ALETSCH_TORCH_DEVICE=name)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
