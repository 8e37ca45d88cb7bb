"""bench_torch.py, the port's benchmark, on the CPU: a cell of config 3
under mode all end to end on the plain versions (at 16 genes x 1 sample,
the smallest cut of config 3 at which the drain, the bridge and the
ladder all have work), an altered output caught by the byte comparison,
no run without a card when cuda is asked for, and the helpers that read
a trace and a CLI's device stats line."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

SMALL = ["--config", "3", "--genes", "16", "--samples", "1", "--reps", "1"]
# bench_torch.main with run_cli wrapped: after each timed port run, one
# byte is appended to the run's first per-sample GTF
ALTER = """import os, sys
sys.path.insert(0, %r)
import bench_torch
run_cli = bench_torch.run_cli


def altered(module, lst, mode, out, env, extra=()):
    res = run_cli(module, lst, mode, out, env, extra)
    if module == "aletsch_tpu_torch" and not extra:
        gtf = os.path.join(out, "gtf", sorted(os.listdir(
            os.path.join(out, "gtf")))[0])
        with open(gtf, "ab") as fh:
            fh.write(b"#")
    return res


bench_torch.run_cli = altered
sys.exit(bench_torch.main(sys.argv[1:]))
"""


def _bench(tmp_path, argv, device="cpu", script=None):
    # one torch thread a process: test workers running side by side only
    # contend
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("ALETSCH_TORCH_DEVICE", None)
    if device is not None:
        env["ALETSCH_TORCH_DEVICE"] = device
    cmd = [sys.executable] + (["-c", script] if script else
                              [os.path.join(REPO, "bench_torch.py")])
    return subprocess.run(cmd + argv + ["--detail",
                                        str(tmp_path / "detail.json")],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600)


def test_cell_runs_on_the_plain_versions(tmp_path):
    res = _bench(tmp_path, SMALL + ["--mode", "all"])
    assert res.returncode == 0, res.stderr[-3000:]
    line = res.stdout.strip().splitlines()[-1]
    assert len(res.stdout.strip().splitlines()) == 1
    j = json.loads(line)
    assert len(line) < 2000
    assert j["correct"] is True and j["config"] == 3 and j["mode"] == "all"
    assert j["seed"] == 77
    assert j["reduced"] == ["genes 16 of 2000", "samples 1 of 10"]
    assert j["value"] > 0 and j["vs_baseline"] > 0
    assert len(j["wall_s_runs"]) == len(j["ref_wall_s_runs"]) == 1
    for stage in ("drain", "bridge", "ladder"):
        assert j["stages"][stage]["dispatches"] > 0, stage
    # no card: every device time null, and the device says so
    assert j["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                           "power_limit": None}
    assert j["idle_share"] is None
    assert j["setup_s"]["cuda_context"] is None
    assert all(s["kernel_ms"] is None for s in j["stages"].values())
    cell = json.load(open(tmp_path / "detail.json"))["cells"][0]
    assert cell["mismatches"] == [] and cell["files"] > 1
    for s in cell["stages"].values():
        assert s["solve_ms"] is s["event_ms"] is s["kernel_ms"] is None
    tr = cell["trace"]
    assert tr["records"] == tr["counts"]["enqueued"] == 0
    assert tr["idle_share"] is tr["idle_share_wall"] is tr["busy_ms"] is None
    assert cell["inprocess"]["bundles"] == cell["bundles"] > 0


def test_an_altered_output_is_not_correct(tmp_path):
    res = _bench(tmp_path, SMALL + ["--mode", "host"],
                 script=ALTER % REPO)
    assert res.returncode == 1, res.stderr[-3000:]
    j = json.loads(res.stdout.strip().splitlines()[-1])
    assert j["correct"] is False
    cell = json.load(open(tmp_path / "detail.json"))["cells"][0]
    assert len(cell["mismatches"]) == 1
    assert "gtf/" in cell["mismatches"][0]
    assert "port run 0" in cell["mismatches"][0]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_a_card_runs_nothing(tmp_path, device):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _bench(tmp_path, SMALL, device=device)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "aletsch_bench_torch").exists()
    assert not (tmp_path / "detail.json").exists()


def _rec(cat, ts, dur, name="k"):
    return {"cat": cat, "ts": ts, "dur": dur, "name": name, "ph": "X"}


def test_idle_share_counts_overlapping_device_records_once():
    events = [
        {"cat": "Trace", "ts": 0, "dur": 1000, "name": "trace", "ph": "X"},
        _rec("kernel", 0, 100), _rec("kernel", 50, 100),   # 0-150
        _rec("kernel", 60, 20),                            # inside it
        _rec("gpu_memcpy", 400, 50),                       # 400-450
        _rec("gpu_memset", 445, 15),                       # to 460
        _rec("cpu_op", 0, 1000), _rec("cuda_runtime", 500, 300,
                                      "cudaLaunchKernel"),
        _rec("python_function", 100, 600)]
    assert bench_torch.device_busy_us(events) == 210.0
    assert bench_torch.capture_window_us(events) == 1000.0
    assert bench_torch.idle_share(events) == pytest.approx(0.79)
    assert bench_torch.idle_share(events, 2100.0) == pytest.approx(0.9)
    assert list(bench_torch.kernel_times(events)) == ["k"]
    count, ms = bench_torch.kernel_times(events)["k"]
    assert count == 5 and ms == pytest.approx(0.285)
    host_only = [events[0], _rec("cpu_op", 0, 1000)]
    assert bench_torch.idle_share(host_only) == 1.0
    with pytest.raises(bench_torch.BenchFailure):
        bench_torch.capture_window_us(events[1:])


def test_stats_line_parser():
    text = "\n".join([
        "[aletsch] assemble done in 1.00s",
        "[aletsch_tpu_torch] device: {'waves': 1, 'fused_trust': True}",
        "[chip_smoke child] - {\"drain\": 3}",
        "[aletsch_tpu_torch] device: {'waves': 6, 'fused_dispatches': 3, "
        "'fused_form': 'cpu_f64', 'ladder_trust': False, 'auto': "
        "{'calibrated': True, 'measured_in_s': 2.25, 'asked': {'drain': "
        "{23: False}}}}",
        "[aletsch] 40 bundles -> 3.6 bundles/s"])
    st = bench_torch.parse_stats(text)
    assert st == {"waves": 6, "fused_dispatches": 3, "fused_form": "cpu_f64",
                  "ladder_trust": False,
                  "auto": {"calibrated": True, "measured_in_s": 2.25,
                           "asked": {"drain": {23: False}}}}
    assert bench_torch.parse_stats("[aletsch] nothing here\n") is None
