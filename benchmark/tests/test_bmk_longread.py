"""longread10.unbridged, BASELINE.json config 4 (PacBio CCS and ONT
samples in turn) under the `unbridged` mix: the cell end to end on the CPU
with the port's plain versions at a cut of 16 genes x 2 samples, the
readers of ladder.host_s and ladder.live_row_share on hand-made passes and
silent on a program without their clock or counters, and the mix's forced
stages all at work on a long-read pass, where `all`'s bridge is not."""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest

from bmk import judge
from bmk import main as bench_main
from bmk import spec
from bmk.window import Pass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "longread10.unbridged"
CUT = {"n_genes": 16, "n_samples": 2}
NEW = ("ladder.host_s", "ladder.live_row_share")


def reader(name):
    return spec.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


def mix(name):
    return spec.load_json(os.path.join(BENCH, "mixes", name + ".json"))


class Run:
    def __init__(self, passes):
        self.passes = passes


def a_pass(phases, stats, error=None):
    p = Pass("out")
    p.phases, p.stats, p.error = dict(phases), dict(stats), error
    return p


# a long-read pass's device stats (the drain, support and ladder at work,
# no bridge), and a second pass where the ladder did not dispatch
LONG_READ = {"fused_dispatches": 3, "fused_total": 7, "fused_agree": 7,
             "fused_trust": True, "ladder_dispatches": 4,
             "ladder_graphs": 12, "ladder_rows_shipped": 16,
             "ladder_paths": 9, "ladder_path_edges": 30,
             "ladder_total": 40, "ladder_agree": 40, "ladder_trust": True,
             "device_support_groups": 5, "host_bridge_insts": 0,
             "device_bridge_insts": 0}
IDLE_LADDER = dict(LONG_READ, ladder_dispatches=0, ladder_graphs=0,
                   ladder_rows_shipped=0)
PHASES = [{"wave.host_dp": 0.5, "wave.host_dp.drain": 0.125,
           "wave.host_dp.bridge": 0.0, "wave.host_dp.support": 0.125,
           "wave.host_dp.ladder": 0.25},
          {"wave.host_dp": 0.25, "wave.host_dp.drain": 0.0,
           "wave.host_dp.bridge": 0.0, "wave.host_dp.support": 0.0,
           "wave.host_dp.ladder": 0.25}]
# the program before the stage clocks and the rows counter
OLD_PHASES = {"wave.host_dp": 0.5, "assemble-regions": 10.0}
OLD_STATS = {k: v for k, v in LONG_READ.items()
             if k not in ("ladder_rows_shipped", "ladder_paths",
                          "ladder_path_edges")}


def test_the_ladders_host_seconds_a_pass():
    run = Run([a_pass(PHASES[0], LONG_READ), a_pass(PHASES[1], IDLE_LADDER)])
    assert reader("ladder.host_s").read(run) == pytest.approx(0.25)


def test_the_live_row_share_leaves_out_a_pass_without_a_dispatch():
    run = Run([a_pass(PHASES[0], LONG_READ), a_pass(PHASES[1], IDLE_LADDER),
               a_pass(PHASES[0], dict(LONG_READ, ladder_graphs=16),
                      error="Traceback")])
    assert reader("ladder.live_row_share").read(run) == pytest.approx(75.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_is_silent_on_a_program_without_its_clock(name):
    run = Run([a_pass(OLD_PHASES, OLD_STATS), a_pass(OLD_PHASES, OLD_STATS)])
    assert reader(name).read(run) is None
    assert reader(name).read(Run([])) is None


def test_the_mix_finds_every_forced_stage_at_work_on_a_long_read_pass():
    p = a_pass(PHASES[0], LONG_READ)
    assert judge.stage_misses(p, mix("unbridged")) == []
    assert judge.refused(p, mix("unbridged")) == 0
    # `all` would count the bridge's two counters idle on every pass
    assert sorted(judge.stage_misses(p, mix("all"))) == [
        "bridge_dispatches", "device_bridge_insts"]


def test_the_mix_is_all_with_the_bridge_off():
    a, u = mix("all"), mix("unbridged")
    flags = dict(zip(a["flags"][::2], a["flags"][1::2]))
    flags["--device_bridge"] = "off"
    assert dict(zip(u["flags"][::2], u["flags"][1::2])) == flags
    assert u["engaged"] == [k for k in a["engaged"] if "bridge" not in k]
    assert (u["trust"], u["agree"]) == (a["trust"], a["agree"])


def test_the_new_metrics_are_in_the_benchmark():
    bench = spec.load_bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, unit, better, source in (
            ("ladder.host_s", "s", "lower", "program_span"),
            ("ladder.live_row_share", "%", "higher", "program_counter")):
        assert entries[name] == {
            "name": name, "unit": unit, "better": better, "source": source,
            "layer": "ladder solver", "moves": "bundles_per_s",
            "workloads": ["pe10.all", "smartseq64.all", CELL]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["config"] == "longread10"
    assert cells[CELL]["traffic"] == "unbridged"
    assert cells[CELL]["chips"] == 1
    for name, m in entries.items():
        assert (CELL in m["workloads"]) == (not name.startswith("bridge")), \
            name


@pytest.fixture(scope="module")
def cpu_runs():
    """The cell on the CPU, untraced and traced: {trace: (exit code, the
    last stdout line as JSON, stderr)}."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    try:
        for trace in (0, 1):
            so, se = io.StringIO(), io.StringIO()
            with redirect_stdout(so), redirect_stderr(se):
                rc = bench_main.main(
                    ["--workload", CELL, "--seed", "2026041899", "--seconds",
                     "0.1", "--trace", str(trace)], on_cpu=True, cut=CUT)
            lines = so.getvalue().strip().splitlines()
            out[trace] = (rc, json.loads(lines[-1]) if lines else None,
                          se.getvalue())
    finally:
        torch.set_num_threads(threads)
    return out


def test_an_untraced_cpu_run_is_correct(cpu_runs):
    rc, line, err = cpu_runs[0]
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"bundles_per_s", "setup_s"}
    assert all(c["value"] == 0 for c in line["checks"].values())


def test_a_traced_cpu_run_reads_the_new_metrics(cpu_runs):
    rc, line, err = cpu_runs[1]
    assert rc == 0, err[-3000:]
    assert line["correct"] is True, line["checks"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert metrics["ladder.host_s"] >= 0.0
    assert line["metrics"]["ladder.host_s"]["unit"] == "s"
    # the CPU ships only the live rows
    assert metrics["ladder.live_row_share"] == pytest.approx(100.0)
    assert line["metrics"]["ladder.live_row_share"]["unit"] == "%"
    assert not [k for k in metrics if k.startswith("bridge")]
    assert metrics["ladder.host_s"] <= metrics["wave.host_dp_s"] + 1e-9
