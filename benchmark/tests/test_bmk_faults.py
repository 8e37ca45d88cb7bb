"""The comparison catches a broken timed path: pe10.all on the CPU at 16
genes x 1 sample, past the harness's look for a card, with one fault
planted in the program's solvers, must print `correct` false; and the
control (controls/drain_f32.py, the drain in float32) must too.  The
cell can have three of the faults a timed path can: an answer altered
where it is produced, half of a batch left out, a step that returns its
state unchanged.  It has no exchange between chips to leave out (one
card)."""

import json

import numpy as np
import pytest

from bmk import main as bench_main

CUT = {"n_genes": 16, "n_samples": 1}


def drain_weight_altered(paths, ws, npaths):
    ws = ws.copy()
    ws[npaths > 0, 0] += 0.5
    return paths, ws, npaths


def drain_half_left_out(paths, ws, npaths):
    npaths = npaths.copy()
    npaths[len(npaths) // 2:] = 0
    return paths, ws, npaths


def ladder_unchanged(larm, ltgt, ndec, status):
    return larm, ltgt, np.zeros_like(ndec), status


def bridge_answer_altered(ostk, par, pix):
    ostk = ostk.copy()
    ostk[:, :, 0, 0] = -1       # no path found for any pier
    return ostk, par, pix


FAULTS = {
    "drain path weight altered": ("aletsch_tpu_torch.ops.greedy_fused",
                                  "DeviceGreedyFused",
                                  drain_weight_altered),
    "drain's second half of each dispatch left out": (
        "aletsch_tpu_torch.ops.greedy_fused", "DeviceGreedyFused",
        drain_half_left_out),
    "ladder returns its graphs unchanged": (
        "aletsch_tpu_torch.ops.ladder_device", "DeviceLadder",
        ladder_unchanged),
    "bridge answer altered": ("aletsch_tpu_torch.ops.bridge_topk",
                              "DeviceBridge", bridge_answer_altered),
}


def run_cell(capsys, extra=()):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        rc = bench_main.main(["--workload", "pe10.all", "--seed", "977",
                              "--seconds", "0.1", "--trace", "0", *extra],
                             on_cpu=True, cut=CUT)
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_is_not_correct(capsys, monkeypatch,
                                                  fault):
    import importlib
    module, cls, bend = FAULTS[fault]
    owner = getattr(importlib.import_module(module), cls)
    solve = owner.solve

    def broken(self, nrows):
        return bend(*solve(self, nrows))

    monkeypatch.setattr(owner, "solve", broken)
    line = run_cell(capsys)
    assert line["correct"] is False, line["checks"]


def test_the_control_is_not_correct(capsys):
    line = run_cell(capsys, ("--control", "drain_f32"))
    assert line["correct"] is False, line["checks"]
    checks = line["checks"]
    assert checks["drain_rows_differing"]["value"] > 0
    assert checks["files_differing"]["value"] == 0


def test_a_control_that_never_acts_gives_no_result(capsys, monkeypatch):
    import types

    from bmk import spec
    idle = types.SimpleNamespace(install=lambda: None, calls=lambda: 0,
                                 remove=lambda: None)
    monkeypatch.setattr(spec, "load_control", lambda name: idle)
    rc = bench_main.main(["--workload", "pe10.all", "--seed", "977",
                          "--seconds", "0.1", "--trace", "0", "--control",
                          "drain_f32"], on_cpu=True, cut=CUT)
    out, err = capsys.readouterr()
    assert rc == 1
    assert out.strip() == ""
    assert "never acted" in err


def test_the_sound_path_is_correct_beside_them(capsys):
    line = run_cell(capsys)
    assert line["correct"] is True, line["checks"]
