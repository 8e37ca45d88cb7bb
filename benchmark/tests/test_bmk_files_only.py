"""A cell, a configuration, a traffic mix and a per-layer metric are
added as new files and BENCHMARK.json entries alone: the harness finds
each by name, and no file it already had is edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

CONFIG = {"name": "tiny_pe", "source": "a test's cut of illumina_pe10",
          "cohort": {"builder": "paired_end",
                     "args": {"n_genes": 40, "n_samples": 2},
                     "warmup_genes": 10},
          "flags": ["--max_num_exons", "8", "--verbose", "0"],
          "reduced": ["n_genes", "n_samples"]}
MIX = {"name": "drain_only",
       "why": "the drain alone on the device, as a later mix would be",
       "flags": ["--device_greedy", "on", "--device_min_vertices", "2",
                 "--device_min_groups", "0", "--device_bridge", "off",
                 "--device_support", "off", "--device_ladder", "off",
                 "--device_similarity", "off"],
       "engaged": ["fused_dispatches", "fused_total"],
       "trust": ["fused_trust"],
       "agree": [["fused_agree", "fused_total"]]}
READER = '''"""passes.count (passes; layer: incubator): whole passes in the
window."""


def read(run):
    return float(len(run.passes))
'''


def tree_digest(root):
    out = {}
    for base, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_a_config_a_mix_and_a_metric_are_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("aletsch_tpu_torch", "native", "build"):
        os.symlink(os.path.join(ROOT, name), tmp_path / name)
    before = tree_digest(tmp_path / "benchmark")
    with open(tmp_path / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    old_entries = json.dumps(bench, sort_keys=True)

    # the new files
    (tmp_path / "benchmark" / "configs" / "tiny_pe.json").write_text(
        json.dumps(CONFIG))
    (tmp_path / "benchmark" / "mixes" / "drain_only.json").write_text(
        json.dumps(MIX))
    (tmp_path / "benchmark" / "metrics" / "passes.count.py").write_text(
        READER)
    # the new entries
    bench["configs"].append({"name": "tiny_pe", "source": CONFIG["source"],
                             "file": "benchmark/configs/tiny_pe.json",
                             "reduced": CONFIG["reduced"],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_pe.drain_only",
                               "config": "tiny_pe", "traffic": "drain_only",
                               "chips": 1, "why": "a test"})
    for m in bench["per_layer"]:
        if "workloads" not in m:
            m["workloads"] = []
    bench["per_layer"].append({"name": "passes.count", "unit": "passes",
                               "better": "higher",
                               "source": "host_clock", "layer": "incubator",
                               "moves": "bundles_per_s",
                               "workloads": ["tiny_pe.drain_only"]})
    with open(tmp_path / "BENCHMARK.json", "w") as fh:
        json.dump(bench, fh)

    code = ("import sys; sys.path.insert(0, 'benchmark'); "
            "import torch; torch.set_num_threads(2); "
            "from bmk.main import main; "
            "sys.exit(main(sys.argv[1:], on_cpu=True))")
    res = subprocess.run(
        [sys.executable, "-c", code, "--workload", "tiny_pe.drain_only",
         "--seed", "5", "--seconds", "0.1", "--trace", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, (line["checks"], res.stderr[-3000:])
    assert line["metrics"]["passes.count"] == {"value": float(
        line["attempted"]), "unit": "passes"}
    # nothing the benchmark had was edited, and its old entries stand
    after = tree_digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        os.path.join("configs", "tiny_pe.json"),
        os.path.join("mixes", "drain_only.json"),
        os.path.join("metrics", "passes.count.py")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        assert json.dumps(json.load(fh), sort_keys=True) == old_entries
