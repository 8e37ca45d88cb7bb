"""The port's device trace: --jax_profile_dir (the JAX package's flag, kept
by name) writes a torch.profiler trace of the region assembly through
tensorboard_trace_handler, and the output bytes do not change.  On the CPU
device the trace records host activity only and makes no CUDA context; a
failure to trace propagates."""

import glob
import json
import os

import pytest
import torch

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.utils import tracing as port_tracing
from torch_helpers import blocked_env, output_bytes

FORCED = ["--device_greedy", "on", "--device_min_vertices", "2",
          "--device_min_groups", "0", "--max_num_exons", "8",
          "--verbose", "0"]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from aletsch_tpu.sim import simulate_adversarial_sample
    base = tmp_path_factory.mktemp("trace_cohort")
    lines = []
    for i, seed in enumerate((21, 22)):
        bam = str(base / ("s%d.bam" % i))
        simulate_adversarial_sample(bam, seed=seed, n_loci=10)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    return str(lst)


def _run(main, lst, out, *extra):
    (out / "gtf").mkdir(parents=True)
    assert main(["-i", lst, "-o", str(out / "meta.gtf"), "-d",
                 str(out / "gtf"), *FORCED, *extra]) == 0
    return output_bytes(str(out / "meta.gtf"), str(out / "gtf"))


def _trace(d):
    files = glob.glob(os.path.join(str(d), "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"]


def test_trace_leaves_a_file_and_the_same_bytes(cohort, tmp_path):
    """A forced-drain run with --jax_profile_dir: the reference's bytes,
    one trace file, and in it the plain drain's operators, which run on the
    incubator's pool threads."""
    ref = _run(ref_main.main, cohort, tmp_path / "ref", "--device_greedy",
               "off")
    trace_dir = tmp_path / "trace"
    got = _run(port_main.main, cohort, tmp_path / "port",
               "--jax_profile_dir", str(trace_dir))
    assert got == ref
    events = _trace(trace_dir)
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::minimum", "aten::amax"} <= ops
    assert not any(e.get("cat") == "kernel" for e in events)
    assert not torch.cuda.is_initialized()


def test_trace_cli_with_jax_blocked(cohort, tmp_path):
    """The same through python -m aletsch_tpu_torch with jax and the JAX
    package unimportable."""
    import subprocess
    import sys
    out, trace_dir = tmp_path / "out", tmp_path / "trace"
    (out / "gtf").mkdir(parents=True)
    res = subprocess.run(
        [sys.executable, "-m", "aletsch_tpu_torch", "-i", cohort, "-o",
         str(out / "meta.gtf"), "-d", str(out / "gtf"), *FORCED,
         "--jax_profile_dir", str(trace_dir)],
        env=blocked_env(str(tmp_path / "shim")), capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert any(e.get("cat") == "cpu_op" for e in _trace(trace_dir))
    ref = _run(ref_main.main, cohort, tmp_path / "ref", "--device_greedy",
               "off")
    assert output_bytes(str(out / "meta.gtf"), str(out / "gtf")) == ref


def test_tracer_activities_follow_the_device(tmp_path):
    from torch.profiler import ProfilerActivity
    tr = port_tracing.Tracer(jax_profile_dir=str(tmp_path))
    tr.start_jax_trace()
    try:
        assert tr._jax_active.activities == {ProfilerActivity.CPU}
        torch.ones(3).add_(1)
    finally:
        tr.stop_jax_trace()
    assert tr._jax_active is False
    assert _trace(tmp_path)
    tr.stop_jax_trace()             # a second stop does nothing


def test_trace_failure_propagates(tmp_path, monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "meta")
    tr = port_tracing.Tracer(jax_profile_dir=str(tmp_path))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tr.start_jax_trace()
    assert tr._jax_active is False


@pytest.mark.cuda
def test_trace_records_the_card(tmp_path, monkeypatch):
    """On a card the trace records its kernels too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cuda")
    tr = port_tracing.Tracer(jax_profile_dir=str(tmp_path))
    tr.start_jax_trace()
    try:
        assert ProfilerActivity.CUDA in tr._jax_active.activities
        torch.ones(3, device="cuda").add_(1)
        torch.cuda.synchronize()
    finally:
        tr.stop_jax_trace()
    assert any(e.get("cat") == "kernel" for e in _trace(tmp_path))
