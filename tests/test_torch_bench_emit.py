"""bench_torch.py's output contract, as tests/test_bench_emit.py holds
bench.py's: the last line of stdout is compact strict JSON, under 2,000
bytes whatever the probes' tables hold, with every field of the headline;
the full tables go to the detail file; a probe's error survives into it
and turns the exit code to 1."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
import bench_torch  # noqa: E402

DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "power_limit": "700.00 W"}
SETUP = {"import_torch_s": 7.06, "cuda_context_s": 0.41, "build_s": 21.5}
HEADLINE_KEYS = {"metric", "value", "unit", "config", "mode", "seed",
                 "reduced", "wall_s", "wall_s_runs", "ref_wall_s",
                 "ref_wall_s_runs", "binary_wall_s", "vs_baseline",
                 "correct", "idle_share", "setup_s", "stages", "device",
                 "detail_file", "probe_errors"}


def _cell(**kw):
    stages = {s: {"dispatches": 2826, "launches": 2826, "solve_ms": 812.5,
                  "event_ms": 114.2, "kernel_ms": 8.19}
              for s in bench_torch.STAGES}
    cell = {"config": 3, "mode": "all", "seed": 77, "reduced": [],
            "value": 31.25, "wall_s": 19.2, "wall_s_runs": [19.2, 19.9, 18.7],
            "ref_wall_s": 7.1, "ref_wall_s_runs": [7.1, 7.0, 7.3],
            "binary_wall_s": None, "vs_baseline": 0.3698, "correct": True,
            "trace": {"idle_share": 0.9962, "note": "y" * 4000},
            "calibration_s_runs": [None, None, None], "stages": stages}
    cell.update(kw)
    return cell


def test_headline_is_compact_json(tmp_path, capsys):
    big = "x" * 4000         # the probe blobs that broke bench.py's round 4
    found = {"policy": {"note": big},
             "mfu": {"kernels": {"a": {"pct_of_hbm_peak": 0.004},
                                 "b": {"error": "no chip"}},
                     "analysis": big},
             "scaling_shape": {"rows": [], "note": big}}
    path = str(tmp_path / "detail.json")
    rc = bench_torch.emit([_cell()], found, DEVICE, SETUP, path)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    j = json.loads(line)                      # strict JSON
    assert len(line) < 2000, "the headline must stay small"
    assert set(j) == HEADLINE_KEYS
    assert j["metric"] == "bundles_per_second" and j["unit"] == "bundles/s"
    assert j["vs_baseline"] == 0.3698 and j["correct"] is True
    assert j["detail_file"] == path and j["device"] == DEVICE
    assert j["stages"]["ladder"] == {"launches": 2826, "dispatches": 2826,
                                     "kernel_ms": 8.19}
    assert j["setup_s"]["import_torch"] == 7.06
    assert rc == 0
    detail = json.load(open(path))
    assert detail["probes"]["policy"]["note"] == big
    assert detail["probes"]["scaling_shape"]["note"] == big
    assert detail["cells"][0]["trace"]["note"] == "y" * 4000


def test_headline_survives_probe_errors(tmp_path, capsys):
    path = str(tmp_path / "detail.json")
    cell = _cell(vs_baseline=None, ref_wall_s=None, ref_wall_s_runs=[])
    found = {k: {"error": "x"} for k in ("policy", "coverage_crossover",
                                          "mfu", "scaling_shape",
                                          "jax_dist", "small", "deep")}
    rc = bench_torch.emit([cell], found, DEVICE, SETUP, path)
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert j["vs_baseline"] == 0.0
    assert j["probe_errors"] == 7
    assert rc == 1
    assert json.load(open(path))["probes"]["mfu"] == {"error": "x"}
