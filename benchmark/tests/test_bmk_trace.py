"""The traced run's reduction on hand-made traces: the card's busy time and
idle gaps, and a capture whose device records differ in number from the
calls that queued them, which the harness refuses to read (no result)."""

import json

import pytest

from bmk import main as bench_main
from bmk import trace

CUT = {"n_genes": 16, "n_samples": 1}


def events(drop=0, extra=0):
    """A 1000 us capture: three kernels and a copy, each queued by one
    runtime call, less `drop` device records, plus `extra` records that
    no call queued."""
    ev = [{"cat": "Trace", "name": "capture", "ph": "X", "ts": 0.0,
           "dur": 1000.0},
          {"cat": "user_annotation", "name": "wave", "ph": "X", "ts": 0.0,
           "dur": 600.0},
          {"cat": "user_annotation", "name": "write-output", "ph": "X",
           "ts": 600.0, "dur": 400.0}]
    device = [("kernel", "drain_kernel", 100.0, 50.0),
              ("kernel", "drain_kernel", 120.0, 50.0),
              ("gpu_memcpy", "Memcpy HtoD", 300.0, 100.0),
              ("kernel", "ladder_kernel", 700.0, 100.0)]
    for cat, name, ts, dur in device[:len(device) - drop]:
        ev.append({"cat": cat, "name": name, "ph": "X", "ts": ts,
                   "dur": dur})
    for i in range(extra):
        ev.append({"cat": "gpu_memset", "name": "Memset", "ph": "X",
                   "ts": 900.0 + i, "dur": 1.0})
    for name in ("cudaLaunchKernel", "cudaLaunchKernel", "cudaMemcpyAsync",
                 "cuLaunchKernelEx"):
        ev.append({"cat": "cuda_runtime", "name": name, "ph": "X",
                   "ts": 0.0, "dur": 1.0})
    return ev


def test_a_whole_capture_is_read():
    red = trace.Reduced(events(), 0)
    assert red.counts == {"kernel": 3, "gpu_memcpy": 1, "gpu_memset": 0,
                          "enqueued": 4}
    assert red.records() == 4 and not red.dropped()
    # [100, 170) + [300, 400) + [700, 800): overlapping records count once
    assert red.busy_us() == 270.0
    assert red.idle_share() == pytest.approx(0.73)
    assert red.kernel_us("drain_kernel") == (2, 100.0)
    gaps = red.idle_gaps()
    assert [g[0] for g in gaps] == ["wave", "write-output", "wave", "wave"]
    assert [g[1] for g in gaps] == pytest.approx([300e-6, 200e-6, 130e-6,
                                                  100e-6])


@pytest.mark.parametrize("drop,extra", [(1, 0), (4, 0), (0, 1)])
def test_a_capture_that_lost_or_gained_records_is_not_read(drop, extra):
    red = trace.Reduced(events(drop, extra), 0)
    assert red.dropped()


def test_the_harness_gives_no_result_for_a_capture_that_lost_records(
        capsys, monkeypatch):
    import torch

    def stop(self, path):
        return trace.Reduced(events(drop=1), 0)

    monkeypatch.setattr(trace.Capture, "stop", stop)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = bench_main.main(["--workload", "pe10.all", "--seed", "5",
                              "--seconds", "0.1", "--trace", "1"],
                             on_cpu=True, cut=CUT)
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 1
    assert out.strip() == ""
    assert "3 device records for 4 calls" in err
    # the same run with the capture whole prints its line
    monkeypatch.undo()
    torch.set_num_threads(2)
    try:
        rc = bench_main.main(["--workload", "pe10.all", "--seed", "5",
                              "--seconds", "0.1", "--trace", "1"],
                             on_cpu=True, cut=CUT)
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["correct"] is True
