"""The port's measured 'auto' policy (aletsch_tpu_torch/ops/crossover.py,
ops/mfu.py, meta/device_wave.py) against the JAX package's, on the CPU.

Same seeded inputs through both packages: the fit arithmetic
(_clamped_line, _fit_rows, device_wins) and the four roofline models give
the reference's numbers exactly (same numpy expressions); the synthetic
drain batch is the reference's array for array.  The measurements
themselves run on the port's CPU device, where a "dispatch" is the plain
PyTorch version: their structure and the agreement of the device results
with the native host functions are pinned, no time is.  The policy's
gates are driven with fake calibrations; every cache path goes to
tmp_path.
"""

import json
import os

import numpy as np
import pytest
import torch

from aletsch_tpu.config import default_params
from aletsch_tpu.ops import crossover as ref_crossover
from aletsch_tpu.ops import mfu as ref_mfu
from aletsch_tpu_torch.meta import bundle_group as port_bundle_group
from aletsch_tpu_torch.meta import device_wave, native_core
from aletsch_tpu_torch.ops import crossover, mfu
from aletsch_tpu_torch.ops.drain import drain_torch
from aletsch_tpu_torch.ops.greedy_fused import batch_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device_and_clean_policy(monkeypatch, tmp_path):
    """The CPU device, a cache path under tmp_path, and no calibration or
    answer left over from another test."""
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    for var in ("ALETSCH_DEVICE", "ALETSCH_DEVICE_BRIDGE",
                "ALETSCH_DEVICE_SUPPORT", "ALETSCH_DEVICE_LADDER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(crossover, "cache_path",
                        lambda: str(tmp_path / "calibration.json"))
    device_wave.reset_policy()
    yield
    device_wave.reset_policy()


def _fit(a, b, c):
    return {"a_fixed_dispatch_s": a, "b_per_graph_device_s": b,
            "c_per_graph_host_s": c}


def _stage(a, b, c, sizes=(1, 64), key="B"):
    """A stage's calibration whose rows lie on its line."""
    return {"fit": _fit(a, b, c),
            "table": [{key: n, "device_dispatch_s": a + b * n}
                      for n in sizes]}


def _fake_calibration(card="Fake H100"):
    """The drain wins from 34 graphs (a 0.3 ms, b 3 us, c 12 us), the
    support reduce from 4 groups; the ladder, the bridge and similarity
    lose at every size."""
    cal = _stage(3e-4, 3e-6, 12e-6, sizes=(16, 64, 256))
    cal.update(platform="cuda", card=card, measured_in_s=1.0, stages={
        "bridge": _stage(14e-3, 5e-5, 12e-6),
        "support": _stage(4.3e-5, 1e-8, 12e-6),
        "ladder": _stage(0.1, 5e-3, 5e-5, sizes=(8, 64)),
        "similarity": _stage(2e-3, 1e-5, 3e-7, sizes=(256, 1024),
                             key="n_bundles")})
    return cal


def _as_cuda(monkeypatch, card="Fake H100"):
    """Make the policy believe it runs on a card named `card`; measuring
    is forbidden unless the test replaces measure_policy.  device_wave
    reads the device's name from ALETSCH_TORCH_DEVICE, and crossover asks
    platform_name."""
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(crossover, "platform_name", lambda device=None: "cuda")
    monkeypatch.setattr(crossover, "card_name", lambda device=None: card)

    def refuse():
        raise AssertionError("the policy measured")
    monkeypatch.setattr(crossover, "measure_policy", refuse)


# ------------------------------------------------------ tests/test_crossover

def test_native_bench_drain_matches_plain_drain():
    """The native standalone drain against the port's plain drain on
    random dense batches: path counts and weights equal exactly."""
    rng = np.random.default_rng(17)
    B, V, maxp = 24, 48, 64
    W = np.full((B, V, V), -1.0e18)
    P = np.full((B, V, V), -1, dtype=np.int32)
    sink = np.zeros(B, dtype=np.int32)
    scal = np.zeros((B, 3))
    for b in range(B):
        n = int(rng.integers(4, V))
        cnt = np.zeros(n, dtype=int)
        for j in range(1, n):
            for u in rng.choice(j, size=min(j, int(rng.integers(1, 4))),
                                replace=False):
                W[b, u, j] = float(rng.integers(1, 500))
                P[b, u, j] = cnt[j]
                cnt[j] += 1
        sink[b] = n - 1
        scal[b] = (2.0, 0.01, 1e-8)
    sink[3] = 0         # inactive rows must stay untouched
    sink[11] = 0
    assert native_core.bench_drain_available()
    ws_n, np_n, build_s, drain_s = native_core.bench_drain(W, P, sink, scal,
                                                           maxp)
    _, ws_o, np_o = (t.numpy() for t in drain_torch(
        *batch_from_numpy(W, P, sink, scal, "cpu"), maxp))
    assert np.array_equal(np_n, np_o)
    assert np.array_equal(ws_n, ws_o)
    assert build_s >= 0.0 and drain_s > 0.0
    assert np_n[3] == 0 and np_n[11] == 0


def test_synth_batch_equals_reference():
    for got, want in zip(crossover.synth_batch(5), ref_crossover.synth_batch(5)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_measure_fit_and_break_even():
    cal = crossover.measure(batches=(8, 16), reps=1)
    assert cal["platform"] == "cpu" and cal["card"] == "cpu"
    assert [r["B"] for r in cal["table"]] == [8, 16]
    for r in cal["table"]:
        assert r["paths_agree"] and r["bit_exact_vs_host"]
        assert r["device_form"] == "cpu_f64"
        assert r["device_dispatch_s"] > 0 and r["device_resident_s"] > 0
        assert r["host_native_drain_s"] > 0
    f = cal["fit"]
    # the fit reproduces a + b*B at the measured points
    t8 = f["a_fixed_dispatch_s"] + 8 * f["b_per_graph_device_s"]
    assert abs(t8 - cal["table"][0]["device_dispatch_s"]) < 0.5
    assert cal["break_even_B"] is None or cal["break_even_B"] > 0
    assert f["a2_resident_launch_s"] is not None


def test_device_wins_model():
    for mod in (crossover, ref_crossover):
        cal = {"fit": _fit(0.10, 1e-5, 1e-3)}
        # break-even at ~101 graphs
        assert not mod.device_wins(100, cal)
        assert mod.device_wins(102, cal)
        assert not mod.device_wins(10, cal)
        assert not mod.device_wins(10, None)
        # marginal device cost above host cost: never wins
        cal["fit"]["b_per_graph_device_s"] = 2e-3
        assert not mod.device_wins(10**9, cal)


def test_cpu_device_measures_nothing_and_reads_no_cache(monkeypatch, tmp_path):
    """On the CPU device 'auto' answers no without measuring and without
    reading a calibration, even one that says the device wins."""
    with open(crossover.cache_path(), "w") as fh:
        json.dump(dict(_fake_calibration(), platform="cpu", card="cpu"), fh)
    monkeypatch.setattr(crossover, "measure_policy",
                        lambda: pytest.fail("measured on the CPU device"))
    cfg = default_params()[0]
    assert crossover.calibration(measure_if_missing=True) is None
    assert device_wave.auto_calibration(cfg) is None
    for stage in crossover.STAGES:
        assert not device_wave.auto_device_ok(cfg, 10**6, stage)
    assert cfg.device_greedy == "auto"
    assert not device_wave.enabled(cfg, n_groups=10**6)


def test_fit_clamps_negative_intercept_and_window():
    """A data set whose unconstrained intercept is negative, and rows
    carried over from another window: both packages give the same line and
    the same rows."""
    Bs = np.array([64.0, 256.0, 1024.0])
    td = np.array([0.001, 0.020, 0.110])
    a, b = crossover._clamped_line(Bs, td)
    assert (a, b) == ref_crossover._clamped_line(Bs, td)
    assert a >= 0.0 and b > 0 and np.all(a + b * Bs > 0)
    assert crossover._clamped_line(Bs[:1], td[:1]) == \
        ref_crossover._clamped_line(Bs[:1], td[:1]) == (0.001, 0.0)
    good = (np.array([8.0, 64.0]), np.array([0.0011, 0.0018]))
    assert crossover._clamped_line(*good) == ref_crossover._clamped_line(*good)

    table = [{"B": 64, "device_dispatch_s": 0.01},
             {"B": 256, "device_dispatch_s": 0.04},
             {"B": 512, "device_dispatch_s": 9.99, "cached": True}]
    for rows in (table, [table[0], table[2]], table[:1]):
        assert crossover._fit_rows(rows) == ref_crossover._fit_rows(rows)
    assert crossover._fit_rows(table)[1] == "fresh"
    assert crossover._fit_rows([table[0], table[2]])[1] == "mixed"


def test_fit_gives_the_reference_arithmetic():
    """_fit: the line, c as the mean of host / B, the break-even as the
    reference's measure() computes them."""
    table = [{"B": 16, "device_dispatch_s": 3.5e-4, "host_s": 1.9e-4},
             {"B": 64, "device_dispatch_s": 5.0e-4, "host_s": 7.7e-4},
             {"B": 256, "device_dispatch_s": 1.1e-3, "host_s": 3.1e-3}]
    fit, be = crossover._fit(table, "host_s")
    Bs = np.array([16.0, 64.0, 256.0])
    a, b = ref_crossover._clamped_line(
        Bs, np.array([r["device_dispatch_s"] for r in table]))
    c = float((np.array([r["host_s"] for r in table]) / Bs).mean())
    assert fit["a_fixed_dispatch_s"] == round(a, 7)
    assert fit["b_per_graph_device_s"] == round(b, 9)
    assert fit["c_per_graph_host_s"] == round(c, 9)
    assert be == int(np.ceil(a / (c - b)))
    # marginal device cost above the host's: no break-even
    assert crossover._fit(table, c=1e-7)[1] is None


# ------------------------------------------------------ the other measures

def test_measure_ladder_agrees_with_native_ladder():
    r = crossover.measure_ladder(batches=(4,), reps=1, V=24, E=96, H=16,
                                 L=16, DMAX=12, DLOG=64)
    row, = r["table"]
    assert row["eligible_and_clean"] >= 2
    assert row["ndec_agree"] == row["eligible_and_clean"]
    assert row["iterations_per_dispatch"] > 0
    assert row["device_dispatch_s"] > 0 and row["host_native_ladder_s"] > 0
    assert r["fit"]["b_per_graph_device_s"] == 0.0      # one row: no slope


def test_measure_similarity_and_coverage_agree_with_host():
    r = crossover.measure_similarity(sizes=(64, 128), reps=1)
    assert [x["n_bundles"] for x in r["table"]] == [64, 128]
    assert all(x["counts_identical"] for x in r["table"])
    rows = r["sparse_form"]["rows"]
    assert all(x["results_identical"] is True for x in rows)
    assert all(x["device_dispatch_s"] > 0 for x in rows)
    assert r["fit"] == r["sparse_form"]["fit"] and "a_fixed_dispatch_s" in r["fit"]
    c = crossover.measure_coverage(batches=(256, 1024), reps=1)
    assert [x["n_regions"] for x in c["table"]] == [256, 1024]
    assert all(x["mx_identical"] and x["ave_dev_within_1e-6"]
               for x in c["table"])


def test_measure_bridge_and_support_use_the_given_host_cost():
    for fn in (crossover.measure_bridge, crossover.measure_support):
        r = fn(1.25e-5, reps=1)
        assert [x["B"] for x in r["table"]] == [1, 64]
        assert r["fit"]["c_per_graph_host_s"] == 1.25e-5
        assert r["full_batch"] == 64


# ------------------------------------------------------------ the policy

@pytest.mark.parametrize("stage,n,want", [
    ("drain", 16, False), ("drain", 33, False), ("drain", 64, True),
    ("drain", 300, True),
    ("support", 3, False), ("support", 16, False),   # own fit wins from 4,
    ("support", 64, True),                           # the drain's from 34
    ("bridge", 64, False), ("bridge", 10**6, False),
    ("ladder", 64, False), ("ladder", 10**6, False),
    ("similarity", 48, False), ("similarity", 4096, False)])
def test_stage_wins_asks_each_stage_its_own_fit(stage, n, want):
    assert crossover.stage_wins(stage, n, _fake_calibration()) is want


def test_stage_wins_needs_the_nearest_measured_row_to_win():
    """A line through rows that grow faster than a line comes out with
    a = 0 and would promise wins at small sizes; the measured row nearest
    to the size asked about must win too."""
    cal = {"fit": _fit(0.0, 1e-6, 2e-6),
           "table": [{"n_bundles": 256, "device_dispatch_s": 2e-3},
                     {"n_bundles": 4096, "device_dispatch_s": 4e-3}]}
    assert crossover.device_wins(48, cal)
    assert not crossover.stage_wins("similarity", 48, {"stages": {
        "similarity": cal}})
    assert crossover.stage_wins("similarity", 3000, {"stages": {
        "similarity": cal}})
    assert not crossover.stage_wins("similarity", 48, None)
    assert not crossover.stage_wins("ladder", 48, {"stages": {}})


def test_calibration_is_cached_and_read_back(monkeypatch):
    _as_cuda(monkeypatch)
    assert crossover.calibration() is None              # nothing cached
    calls = []
    monkeypatch.setattr(crossover, "measure_policy",
                        lambda: calls.append(1) or _fake_calibration())
    assert crossover.calibration(measure_if_missing=True) == _fake_calibration()
    with open(crossover.cache_path()) as fh:
        assert json.load(fh) == _fake_calibration()
    assert crossover.calibration(measure_if_missing=True) == _fake_calibration()
    assert calls == [1]                                 # the second read it


def test_cache_written_for_another_card_is_ignored(monkeypatch):
    _as_cuda(monkeypatch, card="Fake H100")
    crossover.save(_fake_calibration(card="Another Card"))
    assert crossover.calibration() is None
    mine = _fake_calibration(card="Fake H100")
    monkeypatch.setattr(crossover, "measure_policy", lambda: mine)
    assert crossover.calibration(measure_if_missing=True)["card"] == "Fake H100"
    with open(crossover.cache_path()) as fh:
        assert json.load(fh)["card"] == "Fake H100"     # measured again


def test_cache_name_carries_platform_and_card(monkeypatch):
    monkeypatch.undo()                  # the real cache_path
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    _as_cuda(monkeypatch, card="NVIDIA H100 80GB HBM3")
    name = crossover.cache_path().rsplit("/", 1)[1]
    assert name == "aletsch_torch_crossover_cuda_NVIDIA-H100-80GB-HBM3_v1.json"
    assert name != ref_crossover.CACHE_FMT.format(platform="cuda").rsplit(
        "/", 1)[1]


def test_auto_engages_the_drain_alone(monkeypatch):
    """A calibration in which the drain wins from 34 graphs and the
    ladder, the bridge and the support reduce lose: 'auto' engages waves
    of 64 groups for the drain and pauses at no other stage."""
    _as_cuda(monkeypatch)
    cal = _fake_calibration()
    cal["stages"]["support"] = _stage(1e-3, 2e-5, 12e-6)
    crossover.save(cal)
    cfg = default_params()[0]
    assert (cfg.device_greedy, cfg.device_bridge, cfg.device_support,
            cfg.device_ladder) == ("auto",) * 4
    assert device_wave.enabled(cfg, 64) is True
    assert device_wave.enabled(cfg, 20) is False        # below break-even
    assert device_wave.bridge_enabled(cfg, 64) is False
    assert device_wave.ladder_enabled(cfg, 64) is False
    assert device_wave.support_enabled(cfg, 64) is False
    asked = device_wave.device_stats()["auto"]
    assert asked["calibrated"] and asked["measured_in_s"] == 1.0
    assert asked["asked"]["drain"] == {64: True, 20: False}
    for stage in ("bridge", "support", "ladder"):
        assert asked["asked"][stage] == {64: False, 20: False}
    # with the support reduce's own fit winning, a wave of 64 pauses there
    device_wave.reset_policy()
    crossover.save(_fake_calibration())
    assert device_wave.support_enabled(cfg, 64) is True
    assert device_wave.support_enabled(cfg, 20) is False    # the drain loses


def test_enabled_honours_device_min_groups(monkeypatch):
    _as_cuda(monkeypatch)
    cal = _fake_calibration()
    del cal["stages"]["support"]        # no other stage to pull the wave in
    crossover.save(cal)
    cfg = default_params()[0]
    assert device_wave.enabled(cfg, 64) is True
    cfg.device_min_groups = 100
    assert device_wave.enabled(cfg, 64) is False
    assert device_wave.enabled(cfg, 128) is True
    cfg.device_greedy = "off"
    assert device_wave.enabled(cfg, 128) is False


def _counting_measure(monkeypatch):
    """Let the policy measure (a fake calibration) and count how often."""
    calls = []
    monkeypatch.setattr(crossover, "measure_policy",
                        lambda: calls.append(1) or _fake_calibration())
    return calls


@pytest.mark.parametrize("n_groups", [3, 4])
def test_auto_asks_nothing_below_device_min_groups(monkeypatch, n_groups):
    """At the production cohort's wave sizes, below device_min_groups, a
    default cfg's 'auto' stages answer no without asking the policy: no
    calibration is measured or read, no cache is written, no answer is
    recorded (a deliberate difference from the JAX package, whose bridge,
    support and ladder gates ask at any size)."""
    _as_cuda(monkeypatch)
    calls = _counting_measure(monkeypatch)
    cfg = default_params()[0]
    assert cfg.device_min_groups == 16
    assert device_wave.enabled(cfg, n_groups) is False
    for stage in ("bridge", "support", "ladder"):
        assert getattr(device_wave, stage + "_enabled")(cfg, n_groups) \
            is False
    assert calls == []
    assert not os.path.exists(crossover.cache_path())
    assert device_wave.policy == {} and device_wave._AUTO_CAL == ("unset",)
    assert "auto" not in device_wave.device_stats()


@pytest.mark.parametrize("n_groups", [16, 64])
def test_auto_calibrates_once_from_device_min_groups(monkeypatch, n_groups):
    """From device_min_groups up, the first question measures the
    calibration once and caches it; every later one reads it."""
    _as_cuda(monkeypatch)
    calls = _counting_measure(monkeypatch)
    cfg = default_params()[0]
    for _ in range(2):
        device_wave.enabled(cfg, n_groups)
        for stage in ("bridge", "support", "ladder"):
            getattr(device_wave, stage + "_enabled")(cfg, n_groups)
    assert calls == [1]
    with open(crossover.cache_path()) as fh:
        assert json.load(fh) == _fake_calibration()
    asked = device_wave.device_stats()["auto"]
    assert asked["calibrated"] is True
    assert set(asked["asked"]) >= {"bridge", "support", "ladder"}
    assert all(set(v) == {n_groups} for v in asked["asked"].values())


@pytest.mark.parametrize("env,want", [("0", False), ("1", True)])
def test_env_and_on_bypass_the_policy(env, want, monkeypatch):
    """ALETSCH_DEVICE* and 'on' never ask the policy."""
    _as_cuda(monkeypatch)               # a question would try to measure
    cfg = default_params()[0]
    monkeypatch.setenv("ALETSCH_DEVICE", env)
    assert device_wave.enabled(cfg, 1) is want
    monkeypatch.delenv("ALETSCH_DEVICE")
    for stage in ("bridge", "support", "ladder"):
        monkeypatch.setenv("ALETSCH_DEVICE_" + stage.upper(), env)
        assert getattr(device_wave, stage + "_enabled")(cfg, 1) is want
        monkeypatch.delenv("ALETSCH_DEVICE_" + stage.upper())
        setattr(cfg, "device_" + stage, "on")
        assert getattr(device_wave, stage + "_enabled")(cfg, 1) is True
        setattr(cfg, "device_" + stage, "off")
    assert device_wave.policy == {}


def test_similarity_gate_asks_similarity_fit(monkeypatch):
    _as_cuda(monkeypatch)
    cal = _fake_calibration()
    cal["stages"]["similarity"] = _stage(1e-4, 1e-7, 3e-6, sizes=(256, 1024),
                                         key="n_bundles")      # wins from 35
    crossover.save(cal)
    cfg = default_params()[0]
    g = port_bundle_group.BundleGroup("chr1", "+", 0, cfg, {})
    g.gset = [None] * 47                # below device_min_cluster: not asked
    assert g._use_device_similarity() is False
    assert "similarity" not in device_wave.policy
    g.gset = [None] * 300
    assert g._use_device_similarity() is True
    assert device_wave.policy["similarity"] == {300: True}
    cfg.device_similarity = "off"
    assert g._use_device_similarity() is False


# ---------------------------------------------------------- tests/test_mfu

def test_models_equal_reference():
    for name, ref_name, args in (
            ("model_greedy_fused", "model_greedy_fused", (64, 64, 5)),
            ("model_greedy_fused", "model_greedy_fused", (128, 64, 5)),
            ("model_bridge_topk", "model_bridge_topk", (64, 64, 16, 10, 5)),
            ("model_support", "model_support", (64, 16, 64)),
            ("model_bottleneck", "model_pallas_bottleneck", (64, 64))):
        got = getattr(mfu, name)(*args)
        assert got == getattr(ref_mfu, ref_name)(*args)
        assert got[0] > 0 and got[1] > 0
    assert mfu.model_support(64, 16, 64)[0] == 64 * 16 * 64


def test_chip_peaks_lookup():
    h100 = mfu.chip_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_gbps"] == 3350.0 and h100["vector_f64_tflops"] == 34.0
    assert h100["vector_f32_tflops"] == 67.0
    assert h100["tensor_bf16_tflops"] == 989.0
    assert mfu.chip_peaks("NVIDIA H100 PCIe") is h100
    assert mfu.chip_peaks("weird-device") is None
    assert mfu.chip_peaks("cpu") is None
    assert mfu.chip_peaks() is None and mfu.device_kind() == "cpu"


def test_entry_bound_classification():
    peaks = mfu.chip_peaks("NVIDIA H100 80GB HBM3")
    # tiny work over a long dispatch: latency-bound
    e = mfu._entry("x", 0.1, 1e6, 1e6, peaks)
    assert e["bound"] == "latency/serialization"
    # bandwidth-saturating dispatch
    e = mfu._entry("x", 0.001, 1e6, 3350e9 * 0.001 * 0.5, peaks)
    assert e["bound"] == "bandwidth" and e["pct_of_hbm_peak"] == 50.0
    # an f64 entry is stated against the f64 peak, half the f32 one
    e32 = mfu._entry("x", 0.001, 20e9, 1e6, peaks)
    e64 = mfu._entry("x", 0.001, 20e9, 1e6, peaks, f64=True)
    assert e32["bound"] == e64["bound"] == "compute"
    assert e64["vector_peak"] == "vector_f64_tflops"
    assert e64["pct_of_vector_peak"] == pytest.approx(
        e32["pct_of_vector_peak"] * 67.0 / 34.0, rel=1e-3)
    # the shares are the reference's expressions
    ref_peaks = {"hbm_gbps": 3350.0, "vpu_f32_tflops": 67.0}
    r = ref_mfu._entry("x", 0.001, 20e9, 1e6, ref_peaks)
    assert e32["pct_of_vector_peak"] == r["pct_of_vpu_f32_peak"]
    assert e32["pct_of_hbm_peak"] == r["pct_of_hbm_peak"]
    # no peaks -> no bound key
    assert "bound" not in mfu._entry("x", 0.001, 1e6, 1e6, None)


def test_measure_all_on_the_cpu_device():
    out = mfu.measure_all(reps=1)
    assert out["device_kind"] == "cpu" and out["peaks"] is None
    assert set(out["kernels"]) == {"greedy_fused", "bridge_topk",
                                   "support_reduce", "bottleneck"}
    for ent in out["kernels"].values():
        assert ent["dispatch_s"] > 0 and "bound" not in ent
    assert "analysis" not in out
