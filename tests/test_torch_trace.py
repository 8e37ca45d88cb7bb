"""The port's device trace: --jax_profile_dir (the JAX package's flag, kept
by name) writes a torch.profiler trace of the region assembly through
tensorboard_trace_handler, and the output bytes do not change.  On the CPU
device the trace records host activity only and makes no CUDA context; a
failure to trace propagates.  On a card the trace holds a device record of
every kernel and copy the run queued: the card is synchronised before the
profiler stops, and the kernel library links the CUDA runtime torch has
loaded (ops/_build.py::CUDART).  The card's own checks are the cuda-marked
tests here (python3 -m pytest -q -m cuda tests/test_torch_trace.py)."""

import glob
import json
import os
import types

import pytest
import torch

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.ops import _build
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
        events = json.load(fh)["traceEvents"]
    assert port_tracing.read_trace(files[0]) == events
    return events


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


def test_device_counts_pair_records_with_their_enqueueing_calls():
    """device_counts counts the device records by category and the
    runtime and driver calls that queue one each; other calls (a sync, an
    event record) and host operators count nothing."""
    events = [
        {"cat": "cpu_op", "name": "aten::copy_"},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync"},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)"},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "kernel", "name": "void bridge_kernel<false>(...)"},
        {"cat": "cuda_driver", "name": "cuLaunchKernelEx"},
        {"cat": "kernel", "name": "triton_poi_fused"},
        {"cat": "cuda_runtime", "name": "cudaMemsetAsync"},
        {"cat": "gpu_memset", "name": "Memset (Device)"},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize"},
        {"cat": "cuda_runtime", "name": "cudaEventRecord"},
        {"cat": "cuda_runtime", "name": "cudaFuncSetAttribute"},
        {"cat": "ac2g", "name": "flow"},
        {"ph": "M", "name": "process_name"},
    ]
    assert port_tracing.device_counts(events) == {
        "kernel": 2, "gpu_memcpy": 1, "gpu_memset": 1, "enqueued": 4}
    assert port_tracing.device_counts([]) == {
        "kernel": 0, "gpu_memcpy": 0, "gpu_memset": 0, "enqueued": 0}


def test_kernel_build_links_the_shared_cuda_runtime(tmp_path, monkeypatch):
    """Every nvcc command of the kernel build, each source's compile and
    the link, carries the runtime flag: the library takes the CUDA runtime
    torch has loaded, not a static copy of its own; the flag is in the
    build hash.  The commands are captured; no nvcc runs."""
    assert _build.CUDART == ("-cudart", "shared")
    assert " ".join(_build.CUDART) in " ".join(_build.NVCC_FLAGS)
    cmds = []

    def touch(cmd):
        cmds.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()

    class Popen:
        def __init__(self, cmd, **kw):
            touch(cmd)
            self.returncode = 0

        def communicate(self):
            return "", "ptxas info    : Used 32 registers\n"

    def run(cmd, **kw):
        touch(cmd)
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Popen)
    monkeypatch.setattr(_build.subprocess, "run", run)
    path, _ = _build.build()
    assert os.path.exists(path) and os.path.dirname(path) == str(tmp_path)
    compiles = [c for c in cmds if "-c" in c]
    links = [c for c in cmds if "-shared" in c]
    assert len(compiles) == len(_build.SOURCES) and len(links) == 1
    assert len(cmds) == len(compiles) + len(links)
    for cmd in cmds:
        assert cmd[cmd.index("-cudart") + 1] == "shared", cmd
    assert "Used 32 registers" in _build.ptxas_report()
    # the flag is in the hash: a library linked otherwise has another name
    base = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", tuple(
        f for f in _build.NVCC_FLAGS if f not in _build.CUDART))
    assert _build.library_path() != base


class _FakeProfile:
    """torch.profiler.profile's part that the Tracer uses, recording calls
    into a shared list."""

    def __init__(self, calls, activities, **kw):
        self.calls = calls
        self.activities = set(activities)

    def start(self):
        self.calls.append("start")

    def stop(self):
        self.calls.append("stop")


def _fake_trace(monkeypatch, tmp_path, dev):
    """A Tracer whose profiler is _FakeProfile, on a port device `dev`;
    torch.cuda.synchronize records its argument.  Returns (tracer, calls)."""
    import importlib

    import torch.profiler as tp
    port_device = importlib.import_module("aletsch_tpu_torch.device")
    calls = []
    monkeypatch.setattr(tp, "profile",
                        lambda **kw: _FakeProfile(calls, **kw))
    monkeypatch.setattr(port_device, "device", lambda: torch.device(dev))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append(("synchronize", d)))
    return port_tracing.Tracer(jax_profile_dir=str(tmp_path)), calls


def test_stop_synchronizes_the_card_before_the_profiler(tmp_path,
                                                        monkeypatch):
    """On a card, stop_jax_trace waits for the port's device before it
    stops the profiler, so the records of work still queued are in the
    trace."""
    from torch.profiler import ProfilerActivity
    tr, calls = _fake_trace(monkeypatch, tmp_path, "cuda:1")
    tr.start_jax_trace()
    assert tr._jax_active.activities == {ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA}
    tr.stop_jax_trace()
    assert calls == ["start", ("synchronize", torch.device("cuda:1")),
                     "stop"]
    assert tr._jax_active is False
    tr.stop_jax_trace()             # a second stop does nothing
    assert len(calls) == 3


def test_stop_on_the_cpu_device_touches_no_card(tmp_path, monkeypatch):
    """On the CPU device the trace neither synchronises a card nor makes a
    CUDA context, with the real profiler and with the fake one."""
    tr, calls = _fake_trace(monkeypatch, tmp_path, "cpu")
    tr.start_jax_trace()
    tr.stop_jax_trace()
    assert calls == ["start", "stop"]
    monkeypatch.undo()
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    tr = port_tracing.Tracer(jax_profile_dir=str(tmp_path / "real"))
    tr.start_jax_trace()
    torch.ones(4).mul_(2)
    tr.stop_jax_trace()
    events = _trace(tmp_path / "real")
    assert port_tracing.device_counts(events) == {
        "kernel": 0, "gpu_memcpy": 0, "gpu_memset": 0, "enqueued": 0}
    assert not torch.cuda.is_initialized()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
def test_traced_drain_holds_one_kernel_event_a_launch(cohort, tmp_path):
    """A traced forced drain on the card, the CLI as a user runs it (its
    one capture): the trace holds exactly one drain_kernel record for each
    launch, and a device record for every kernel and copy queued; the
    bytes are the reference's."""
    import ast
    import subprocess
    import sys
    _need_card()
    ref = _run(ref_main.main, cohort, tmp_path / "ref", "--device_greedy",
               "off")
    out, trace_dir = tmp_path / "port", tmp_path / "trace"
    (out / "gtf").mkdir(parents=True)
    res = subprocess.run(
        [sys.executable, "-m", "aletsch_tpu_torch", "-i", cohort, "-o",
         str(out / "meta.gtf"), "-d", str(out / "gtf"), *FORCED,
         "--verbose", "1", "--jax_profile_dir", str(trace_dir)],
        env=blocked_env(str(tmp_path / "shim"), ALETSCH_TORCH_DEVICE="cuda"),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert output_bytes(str(out / "meta.gtf"), str(out / "gtf")) == ref
    line = [ln for ln in res.stderr.splitlines()
            if ln.startswith("[aletsch_tpu_torch] device:")][-1]
    launches = ast.literal_eval(line.split("device:", 1)[1].strip())[
        "drain_launches"]
    events = _trace(trace_dir)
    drains = [e for e in events if e.get("cat") == "kernel"
              and "drain_kernel" in e.get("name", "")]
    assert launches > 0 and len(drains) == launches
    c = port_tracing.device_counts(events)
    assert c["kernel"] + c["gpu_memcpy"] + c["gpu_memset"] == c["enqueued"]


# one process, young, captures one solve() of each solver at each row
# count back to back and prints the device counts of each capture
_SOLVES = """
import json, sys, tempfile
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from aletsch_tpu_torch.ops import bridge_topk as BT, ladder_kernel as LK
from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
from aletsch_tpu_torch.utils import tracing
dev = torch.device("cuda")
bridge = BT.DeviceBridge(device=dev)
for stage, a in zip((bridge.P, bridge.Wt, bridge.Lv, bridge.tgt),
                    BT.fuzz_batch(np.random.default_rng(41), 64, ties=True)):
    stage[...] = a
shape = (LK.DEFAULT_V, LK.DEFAULT_E, LK.DEFAULT_H, LK.DEFAULT_L)
_, states = LK.fuzz_states(range(64), *shape)
ladder = DeviceLadder(device=dev)
ladder.stage_states(LK.pack_states(states, 64, *shape), 64)
out = {}
for kind, solver in (("bridge", bridge), ("ladder", ladder)):
    for rows in (1, 64):
        solver.solve(rows)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solver.solve(rows)
            torch.cuda.synchronize()
        path = tempfile.mktemp(suffix=".json")
        prof.export_chrome_trace(path)
        events = tracing.read_trace(path)
        out["%s %d" % (kind, rows)] = [tracing.device_counts(events), [
            e["name"] for e in events if e.get("cat") == "kernel"]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def profiled_solves(tmp_path_factory):
    """{"<solver> <rows>": (device counts, kernel names)} of one profiled
    solve() of the bridge and of the ladder at 1 and 64 rows, on the
    card, in a process of their own."""
    import subprocess
    import sys
    _need_card()
    shim = str(tmp_path_factory.mktemp("solves_shim"))
    res = subprocess.run([sys.executable, "-c", _SOLVES],
                         env=blocked_env(shim, ALETSCH_TORCH_DEVICE="cuda"),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bridge", "ladder"])
@pytest.mark.parametrize("rows", [1, 64])
def test_profiled_solve_records_three_device_operations(kind, rows,
                                                        profiled_solves):
    """One profiled solve() of the bridge and of the ladder on the card
    records exactly its copy in, its kernel and its copy out."""
    counts, kernels = profiled_solves["%s %d" % (kind, rows)]
    assert counts == {"kernel": 1, "gpu_memcpy": 2, "gpu_memset": 0,
                      "enqueued": 3}
    assert len(kernels) == 1 and kind + "_kernel" in kernels[0]
