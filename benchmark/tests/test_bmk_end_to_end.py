"""pe10.all end to end on the CPU with the port's plain versions, at the
smallest cut where the drain, bridge and ladder all work (16 genes x 1
sample): the result line's keys, an altered pass output judged not
correct, and the runs that must end before any pass."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bmk import main as bench_main
from bmk import window

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CUT = {"n_genes": 16, "n_samples": 1}
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture
def cpu_run(capsys):
    """Run a cell on the CPU in this process; (exit code, the last stdout
    line as JSON or None, stderr)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)

    def run(cell, trace=0, seed=20260417, extra=()):
        rc = bench_main.main(["--workload", cell, "--seed", str(seed),
                              "--seconds", "0.1", "--trace", str(trace),
                              *extra], on_cpu=True, cut=CUT)
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, json.loads(lines[-1]) if lines else None, err

    yield run
    torch.set_num_threads(threads)


def check_line(line, traced):
    keys = list(line)
    want = REQUIRED | {"checks"} | ({"breakdown"} if traced else set())
    assert set(keys) == want
    assert keys[-1] == "checks"
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    for name, m in line["metrics"].items():
        assert set(m) == {"unit", "value"}, name
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])


def test_untraced_run_prints_the_end_to_end_metrics(cpu_run):
    rc, line, err = cpu_run("pe10.all")
    assert rc == 0, err[-3000:]
    check_line(line, traced=False)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"bundles_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in line["checks"].values())
    # the compared numbers are also the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_traced_run_prints_the_per_layer_metrics_and_a_breakdown(cpu_run):
    rc, line, err = cpu_run("pe10.all", trace=1)
    assert rc == 0, err[-3000:]
    check_line(line, traced=True)
    assert line["correct"] is True
    # off the card nothing is read from device records: the device's
    # metrics stay silent, the host's are there
    assert {"incubator.profile_s", "incubator.assemble_s", "waves.host_s",
            "drain.solve_s", "bridge.solve_s", "ladder.solve_s",
            "startup.import_s", "startup.warmup_s",
            "inputs.cohort_s"} == set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_an_altered_pass_output_is_not_correct(cpu_run, monkeypatch):
    orig = window.run_pass

    def altered(port, lst, out, flags):
        p = orig(port, lst, out, flags)
        path = os.path.join(out, "meta.gtf")
        with open(path) as fh:
            text = fh.read()
        with open(path, "w") as fh:
            fh.write(text.replace("transcript_id", "transcript_Id", 1))
        return p

    monkeypatch.setattr(window, "run_pass", altered)
    rc, line, err = cpu_run("pe10.all")
    assert rc == 0, err[-3000:]
    assert line["correct"] is False
    assert line["failed"] == line["attempted"]
    assert line["checks"]["files_differing"]["value"] >= 1
    assert line["checks"]["lines_differing"]["value"] >= 1


def test_asking_for_the_card_without_one_ends_before_any_run():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "pe10.all",
         "--seed", "3", "--seconds", "10", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr
    assert "warm-up" not in res.stderr and "passes" not in res.stderr


def test_a_tree_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for argv in (["benchmark/run.py"],
                 ["-c", "import sys; sys.path.insert(0, 'benchmark'); "
                  "from bmk.main import main; "
                  "sys.exit(main(sys.argv[1:], on_cpu=True))"]):
        res = subprocess.run(
            [sys.executable, *argv, "--workload", "pe10.all", "--seed", "3",
             "--seconds", "10", "--trace", "0"], cwd=tmp_path,
            capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert res.stdout == ""
