"""The harness on the card (marker cuda; skips without one, decided in a
fixture): pe10.all at a small cut, traced, reads the device's metrics,
every roofline share in (0, 100], and is correct.

    python3 -m pytest -q -m cuda benchmark/tests
"""

import json

import pytest

from bmk import main as bench_main

CUT = {"n_genes": 60, "n_samples": 2}
DEVICE_METRICS = ("ladder_kernel_roofline", "bridge_kernel_roofline",
                  "drain_kernel_roofline", "device.idle_share")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_device(card, capsys):
    rc = bench_main.main(["--workload", "pe10.all", "--seed", "2026",
                          "--seconds", "1", "--trace", "1"], cut=CUT)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] < line["device"]["window_s"]
    for name in DEVICE_METRICS:
        assert 0 < line["metrics"][name]["value"] <= 100, name
