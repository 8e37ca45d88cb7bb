"""The readers of the native wave pool's metrics: wave.pool_width
(metrics/wave.pool_width.py), the mean batch of the pool, pool_handles /
pool_calls of a pass's device stats, and wave.pool_task_s
(metrics/wave.pool_task_s.py), the seconds its tasks took, on hand-made
passes; silent on the passes of a program without the pool, and
wave.pool_width on passes where the pool took no batch; in the benchmark
for the three cells; and read in a traced run of pe10.all on the CPU (16
genes x 3 samples: waves of two to four groups, where the drain, the
bridge and the ladder all dispatch)."""

import json
import os

import pytest

from bmk import main as bench_main
from bmk import spec
from bmk.window import Pass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "wave.pool_width"


TASK = "wave.pool_task_s"


def reader(name=NAME):
    return spec.load_module(os.path.join(BENCH, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


class Run:
    def __init__(self, passes):
        self.passes = passes


def a_pass(stats, error=None):
    p = Pass("out")
    p.phases = {"assemble-regions": 10.0, "wave": 8.0}
    p.stats, p.error = dict(stats), error
    return p


POOL = [{"pool_calls": 4, "pool_handles": 10, "inline_advances": 7,
         "prestarted_groups": 12},
        {"pool_calls": 2, "pool_handles": 12, "inline_advances": 1,
         "prestarted_groups": 9}]


@pytest.mark.parametrize("passes,want", [
    (POOL, (10 / 4 + 12 / 2) / 2),
    # a pass that failed is left out
    (POOL[:1] + [dict(POOL[1], error="Traceback")], 10 / 4),
    # a pass where the pool took no batch (every batch of one) is left out
    (POOL[:1] + [{"pool_calls": 0, "pool_handles": 0,
                  "inline_advances": 9, "prestarted_groups": 3}], 10 / 4),
])
def test_the_reader_on_hand_made_passes(passes, want):
    run = Run([a_pass({k: v for k, v in st.items() if k != "error"},
                      st.get("error")) for st in passes])
    assert reader().read(run) == pytest.approx(want)


@pytest.mark.parametrize("stats", [
    {"fused_dispatches": 3, "fused_device_time": 1.0},   # no pool
    {"pool_calls": 0, "pool_handles": 0, "inline_advances": 5,
     "prestarted_groups": 0}])                          # -t 1
def test_the_reader_is_silent_without_a_pool_batch(stats):
    assert reader().read(Run([a_pass(stats), a_pass(stats)])) is None
    assert reader().read(Run([])) is None


@pytest.mark.parametrize("passes,want", [
    ([{"pool_task_s": 3.0}, {"pool_task_s": 5.0}], 4.0),
    # a pass that failed is left out
    ([{"pool_task_s": 3.0}, {"pool_task_s": 5.0, "error": "Traceback"}],
     3.0),
    # a program without the pool
    ([{"fused_dispatches": 3}, {"fused_dispatches": 4}], None),
])
def test_the_task_seconds_reader_on_hand_made_passes(passes, want):
    run = Run([a_pass({k: v for k, v in st.items() if k != "error"},
                      st.get("error")) for st in passes])
    got = reader(TASK).read(run)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("name,unit,better", [
    (NAME, "handles", "higher"), (TASK, "s", "lower")])
def test_the_metric_is_in_the_benchmark_for_the_three_cells(name, unit,
                                                            better):
    bench = spec.load_bench()
    m = {e["name"]: e for e in bench["per_layer"]}[name]
    assert m == {"name": name, "unit": unit, "better": better,
                 "source": "program_counter",
                 "layer": "region assembly and device waves",
                 "moves": "bundles_per_s",
                 "workloads": ["pe10.all", "smartseq64.all", "pe10.fused"]}


def test_a_cpu_run_reads_the_pool_width(capsys):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = bench_main.main(["--workload", "pe10.all", "--seed",
                              "20260417", "--seconds", "0.1", "--trace",
                              "1"], on_cpu=True,
                             cut={"n_genes": 16, "n_samples": 3})
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    width = line["metrics"][NAME]
    assert width["unit"] == "handles"
    assert width["value"] >= 2.0
    assert line["metrics"][TASK]["value"] > 0
