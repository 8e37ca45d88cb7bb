"""The readers of the program's spans and sync clocks (bmk/spans.py and
their metrics/<name>.py): each on hand-made passes, each silent on the
passes of a program that has no such span or clock, and all of them
reading a number in a traced run of pe10.all on the CPU (16 genes x 1
sample, where the drain, the bridge and the ladder all dispatch)."""

import json
import os

import pytest

from bmk import main as bench_main
from bmk import spec
from bmk.window import Pass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = {"n_genes": 16, "n_samples": 1}
SPANS = {"region.scan_wait_s": "region.scan_wait",
         "region.cluster_s": "region.cluster",
         "region.backpressure_s": "region.backpressure",
         "replay.idle_s": "replay.idle", "replay.fold_s": "replay.fold",
         "wave.export_s": "wave.export", "wave.host_dp_s": "wave.host_dp"}
SYNCS = {"drain.sync_s": ("fused_sync_time", "fused_dispatches"),
         "bridge.sync_s": ("bridge_sync_time", "bridge_dispatches"),
         "ladder.sync_s": ("ladder_sync_time", "ladder_dispatches")}
NEW = sorted(SPANS) + ["wave.native_s", "wave.python_s"] + sorted(SYNCS)


def reader(name):
    return spec.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


class Run:
    def __init__(self, passes):
        self.passes = passes


def a_pass(phases, stats, error=None):
    p = Pass("out")
    p.phases, p.stats, p.error = dict(phases), dict(stats), error
    return p


# two passes of a program with the spans: all three stages dispatched in
# the first, the bridge none in the second
PHASES = [{"assemble-regions": 10.0, "region.start": 3.0,
           "region.scan_wait": 1.0, "region.cluster": 0.5,
           "region.backpressure": 6.0, "replay.idle": 0.5, "wave": 9.0,
           "wave.start": 1.0, "wave.round": 7.0, "wave.consume.drain": 0.5,
           "wave.consume.ladder": 1.5, "wave.finish": 0.5,
           "wave.export": 0.75, "wave.host_dp": 0.25, "replay.fold": 0.25},
          {"assemble-regions": 8.0, "region.start": 2.0,
           "region.scan_wait": 0.5, "region.cluster": 0.25,
           "region.backpressure": 5.0, "replay.idle": 1.0, "wave": 6.5,
           "wave.start": 0.5, "wave.round": 5.5,
           "wave.consume.drain": 0.25, "wave.finish": 0.25,
           "wave.export": 0.5, "wave.host_dp": 0.0, "replay.fold": 0.5}]
STATS = [{"fused_device_time": 1.0, "ladder_device_time": 2.0,
          "bridge_device_time": 0.5, "fused_sync_time": 0.25,
          "ladder_sync_time": 1.5, "bridge_sync_time": 0.125,
          "fused_dispatches": 3, "ladder_dispatches": 2,
          "bridge_dispatches": 1, "fused_kernel_time": 0.01},
         {"fused_device_time": 0.5, "ladder_device_time": 1.0,
          "bridge_device_time": 0.0, "fused_sync_time": 0.125,
          "ladder_sync_time": 0.5, "bridge_sync_time": 0.0,
          "fused_dispatches": 2, "ladder_dispatches": 1,
          "bridge_dispatches": 0, "fused_kernel_time": 0.005}]
WANT = {"region.scan_wait_s": 0.75, "region.cluster_s": 0.375,
        "region.backpressure_s": 5.5, "replay.idle_s": 0.75,
        "replay.fold_s": 0.375, "wave.export_s": 0.625,
        "wave.host_dp_s": 0.125,
        # (1 + 0.5 + 1.5 + 0.5 + 0.5 + 0.25 + 0.25) / 2
        "wave.native_s": 2.25,
        # (9 - 3.5 - 0.75 - 0.25 - 3.5 + 6.5 - 1 - 0.5 - 0 - 1.5) / 2:
        # the kernel clock is not a solve() clock
        "wave.python_s": 2.25,
        "drain.sync_s": 0.1875, "ladder.sync_s": 1.0,
        # the pass where the bridge did not dispatch is left out
        "bridge.sync_s": 0.125}


@pytest.mark.parametrize("name", NEW)
def test_a_reader_on_hand_made_passes(name):
    run = Run([a_pass(ph, st) for ph, st in zip(PHASES, STATS)])
    assert reader(name).read(run) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_a_reader_leaves_out_a_pass_that_failed(name):
    run = Run([a_pass(PHASES[0], STATS[0]),
               a_pass(PHASES[1], STATS[1], error="Traceback")])
    first = Run([a_pass(PHASES[0], STATS[0])])
    assert reader(name).read(run) == reader(name).read(first)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_is_silent_on_a_program_without_spans(name):
    """An older program: its phases only, its solve() clocks only."""
    phases = {"index-inputs": 0.1, "profile-samples": 2.0,
              "assemble-regions": 10.0, "write-output": 0.5}
    stats = {k: v for k, v in STATS[0].items()
             if not k.endswith("sync_time")}
    run = Run([a_pass(phases, stats), a_pass(phases, stats)])
    assert reader(name).read(run) is None
    assert reader(name).read(Run([])) is None


def test_every_new_metric_is_in_the_benchmark_where_its_stage_runs():
    bench = spec.load_bench()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert (m["unit"], m["better"], m["moves"]) == \
            ("s", "lower", "bundles_per_s")
        want = {"drain.sync_s": ["pe10.all", "pe10.fused"],
                "bridge.sync_s": ["pe10.all", "smartseq64.all"],
                "ladder.sync_s": ["pe10.all", "smartseq64.all"]}.get(
            name, ["pe10.all", "smartseq64.all", "pe10.fused"])
        assert m["workloads"] == want, name
        assert m["source"] == ("program_counter" if name in SYNCS
                               else "program_span")


def test_a_traced_cpu_run_reads_every_new_metric(capsys):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        # the seed of test_bmk_end_to_end.py: at this cut some seeds give
        # the drain nothing to do, which the comparison reads as a stage
        # left idle
        rc = bench_main.main(["--workload", "pe10.all", "--seed",
                              "20260417", "--seconds", "0.1", "--trace",
                              "1"], on_cpu=True, cut=CUT)
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    for name in NEW:
        assert name in metrics, name
        assert metrics[name] >= 0.0, name
        assert line["metrics"][name]["unit"] == "s"
    # the replay thread's spans cover region assembly; the waves' parts
    # lie inside the waves (the CPU's sync clocks read 0: no card)
    covered = metrics["replay.idle_s"] + metrics["replay.fold_s"]
    assert covered < metrics["incubator.assemble_s"]
    assert metrics["wave.python_s"] >= 0.0
    for stage in ("drain", "bridge", "ladder"):
        assert metrics[stage + ".sync_s"] <= metrics[stage + ".solve_s"]
