"""The port's cohort CLI (python -m aletsch_tpu_torch) against the JAX
package on the adversarial cohort of test_device_greedy_fused.py, with the
greedy decomposition forced onto the device (the plain PyTorch versions on
the CPU), fused and in step mode (ALETSCH_DEVICE_GREEDY=step), and with the
bridge top-K DP, the support reduce and the resolution ladder forced on,
each alone and all together: every output file byte-identical, the device
engaged, trust and verify mode, the device gates, and runs with jax and
the JAX package both unimportable
(also at the CLI's defaults and with --device_similarity on): the port
owns every module it runs."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu.config import default_params
from aletsch_tpu.meta import device_wave as ref_wave
from aletsch_tpu.ops import greedy_dp as ref_greedy_dp
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.io import bam_native as port_bam_native
from aletsch_tpu_torch.meta import device_wave as port_wave
from aletsch_tpu_torch.meta import native_core
from torch_helpers import load_reference_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORCED = ["--device_min_vertices", "2", "--device_min_groups", "0",
          "--max_num_exons", "8", "--verbose", "0"]

needs_native = pytest.mark.skipif(
    os.environ.get("ALETSCH_NATIVE_CORE") == "0",
    reason="device path requires the native core")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _reference_native():
    """Both packages see the native library: the gates and runs below
    compare them on it."""
    assert load_reference_native() == port_bam_native.native_available()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    from aletsch_tpu.sim import simulate_adversarial_sample
    base = tmp_path_factory.mktemp("cohort")
    lines = []
    for i, seed in enumerate((21, 22)):
        bam = str(base / ("s%d.bam" % i))
        simulate_adversarial_sample(bam, seed=seed, n_loci=10)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    return str(lst)


def _run(main, lst, out, greedy, extra=()):
    (out / "gtf").mkdir(parents=True)
    rc = main(["-i", lst, "-o", str(out / "meta.gtf"), "-d",
               str(out / "gtf"), "--device_greedy", greedy, *FORCED,
               *extra])
    assert rc == 0
    files = {"meta.gtf": (out / "meta.gtf").read_bytes()}
    for f in sorted(os.listdir(out / "gtf")):
        files[f] = (out / "gtf" / f).read_bytes()
    return files


@pytest.fixture(scope="module")
def reference_off(cohort, tmp_path_factory):
    return _run(ref_main.main, cohort, tmp_path_factory.mktemp("ref_off"),
                "off")


@pytest.fixture(scope="module")
def support_cohort(tmp_path_factory):
    """Two samples with shared loci coordinates, so that bundle_group
    builds multi-sample groups and the support maps are non-trivial (the
    cohort of test_device_support.py)."""
    from aletsch_tpu.sim import simulate_sample
    base = tmp_path_factory.mktemp("support_cohort")
    lines = []
    for i, seed in enumerate((41, 42)):
        bam = str(base / ("s%d.bam" % i))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    return str(lst)


# stage -> (CLI flag, the wave counter and the solver counters that must
# grow when the stage engages)
STAGES = {
    "bridge": ("--device_bridge", "device_bridge_insts",
               ("bridge_dispatches", "bridge_instances")),
    "support": ("--device_support", "device_support_groups",
                ("support_dispatches", "support_groups")),
    "ladder": ("--device_ladder", "device_ladder_graphs",
               ("ladder_dispatches", "ladder_graphs", "ladder_decisions",
                "ladder_iterations")),
}


def _stage_flags(stages):
    return [x for s in stages for x in (STAGES[s][0], "on")]


def _assert_engaged(stages, st0, st):
    for s in stages:
        _, wave_key, solver_keys = STAGES[s]
        for k in (wave_key, *solver_keys):
            assert st[k] > st0.get(k, 0), "%s: %s never grew" % (s, k)
    if "ladder" in stages:
        assert st["ladder_trust"] is True
        assert st["ladder_total"] > st0.get("ladder_total", 0)
        assert st["ladder_agree"] - st0.get("ladder_agree", 0) == \
            st["ladder_total"] - st0.get("ladder_total", 0)


@needs_native
def test_port_on_matches_reference_off_and_on(cohort, reference_off,
                                              tmp_path):
    ref_on = _run(ref_main.main, cohort, tmp_path / "ref_on", "on")
    agree0, total0 = map(int, native_core.fused_stats)
    graphs0 = port_wave.device_stats().get("fused_graphs", 0)
    port_on = _run(port_main.main, cohort, tmp_path / "port_on", "on")
    assert len(reference_off) > 1 and len(reference_off["meta.gtf"]) > 0
    assert port_on == reference_off
    assert port_on == ref_on
    st = port_wave.device_stats()
    assert st["fused_form"] == "cpu_f64"
    assert st["fused_graphs"] > graphs0, "the drain never engaged"
    assert st["fused_trust"] is True
    agree, total = map(int, native_core.fused_stats)
    assert total > total0
    assert agree - agree0 == total - total0
    assert st["drain_launches"] == 0        # no kernel launch on the CPU


@needs_native
def test_port_off_matches_reference_off(cohort, reference_off, tmp_path):
    graphs0 = port_wave.device_stats().get("fused_graphs", 0)
    assert _run(port_main.main, cohort, tmp_path / "p", "off") == \
        reference_off
    assert port_wave.device_stats().get("fused_graphs", 0) == graphs0


@needs_native
def test_port_verify_mode_parity(cohort, reference_off, tmp_path,
                                 monkeypatch):
    """ALETSCH_FUSED_TRUST=0: the host drain is authoritative and the
    device paths only feed the agreement stats, which must all agree."""
    monkeypatch.setenv("ALETSCH_FUSED_TRUST", "0")
    monkeypatch.setattr(port_wave, "_FUSED_TRUST", False)
    agree0, total0 = map(int, native_core.fused_stats)
    assert _run(port_main.main, cohort, tmp_path / "v", "on") == \
        reference_off
    agree, total = map(int, native_core.fused_stats)
    assert total > total0
    assert agree - agree0 == total - total0


@needs_native
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_alone_matches_reference(stage, cohort, reference_off,
                                       support_cohort, tmp_path,
                                       monkeypatch):
    """One of --device_bridge / --device_support / --device_ladder forced
    on with the greedy stage left off: the wave engages all the same (and
    the drain with it), the bytes are the reference's host run's and its
    own forced run's, and the stage consumed device results.  The
    ladder's rows, as the native export staged them, hold no -0.0 (nor
    negative) weight: the one input where the ladder kernel's final
    weights may differ from the plain form's, in the sign of a zero."""
    from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
    signed = []
    solve = DeviceLadder.solve

    def watch(self, nrows):
        signed.append(int(np.signbit(self.ewrt[:nrows]).sum()))
        return solve(self, nrows)
    monkeypatch.setattr(DeviceLadder, "solve", watch)
    lst, want = cohort, reference_off
    if stage == "support":
        lst = support_cohort
        want = _run(ref_main.main, lst, tmp_path / "ref_off", "off")
    flags = _stage_flags([stage])
    ref_on = _run(ref_main.main, lst, tmp_path / "ref_on", "off", flags)
    st0 = port_wave.device_stats()
    port_on = _run(port_main.main, lst, tmp_path / "port_on", "off", flags)
    assert len(want) > 1 and len(want["meta.gtf"]) > 0
    assert port_on == want
    assert port_on == ref_on
    st = port_wave.device_stats()
    _assert_engaged([stage], st0, st)
    assert st["waves"] > st0["waves"], "a forced stage engages the wave"
    if stage != "support":      # and the drain with it, where graphs pause
        assert st["fused_graphs"] > st0.get("fused_graphs", 0)
    for other in set(STAGES) - {stage}:
        assert st[STAGES[other][1]] == st0[STAGES[other][1]]
    assert bool(signed) == (stage == "ladder") and not any(signed)


@needs_native
def test_all_stages_together_match_reference(cohort, reference_off,
                                             tmp_path):
    flags = _stage_flags(sorted(STAGES))
    ref_on = _run(ref_main.main, cohort, tmp_path / "ref_on", "on", flags)
    st0 = port_wave.device_stats()
    port_on = _run(port_main.main, cohort, tmp_path / "port_on", "on", flags)
    assert port_on == reference_off
    assert port_on == ref_on
    st = port_wave.device_stats()
    _assert_engaged(["bridge", "ladder"], st0, st)
    assert st["fused_graphs"] > st0.get("fused_graphs", 0)
    assert st["fused_agree"] - st0.get("fused_agree", 0) == \
        st["fused_total"] - st0.get("fused_total", 0)
    # amortization: the ladder batches graphs across the wave's groups
    d = st["ladder_dispatches"] - st0.get("ladder_dispatches", 0)
    g = st["ladder_graphs"] - st0.get("ladder_graphs", 0)
    assert d <= g


@needs_native
def test_all_stages_support_cohort(support_cohort, tmp_path):
    """All three stages and the drain on the cohort whose groups span both
    samples: the support reduce engages beside the others."""
    flags = _stage_flags(sorted(STAGES))
    want = _run(ref_main.main, support_cohort, tmp_path / "ref_off", "off")
    st0 = port_wave.device_stats()
    got = _run(port_main.main, support_cohort, tmp_path / "port_on", "on",
               flags)
    assert got == want
    st = port_wave.device_stats()
    _assert_engaged(["support"], st0, st)


@needs_native
def test_ladder_verify_mode_parity(cohort, reference_off, tmp_path,
                                   monkeypatch):
    """Ladder verify mode (as on a device whose f64 is not IEEE-exact): the
    host ladder is authoritative, the bytes are unchanged, and every device
    decision agrees with the host's on this exact device."""
    port_wave._get_ladder_device()
    monkeypatch.setattr(port_wave, "_LADDER_TRUST", False)
    agree0, total0 = map(int, native_core.ladder_stats)
    got = _run(port_main.main, cohort, tmp_path / "v", "off",
               _stage_flags(["ladder"]))
    assert got == reference_off
    assert port_wave.device_stats()["ladder_trust"] is False
    agree, total = map(int, native_core.ladder_stats)
    assert total > total0
    assert agree - agree0 == total - total0


@needs_native
@pytest.mark.parametrize("pallas", [None, "1"])
def test_step_mode_matches_reference(pallas, cohort, reference_off,
                                     tmp_path, monkeypatch):
    """ALETSCH_DEVICE_GREEDY=step: the port's bytes equal the reference's
    host run and the reference's own step run (XLA scan, or TPU kernel #2
    in interpret mode under ALETSCH_PALLAS_GREEDY=1, which the port
    ignores), with the per-extraction tables engaged."""
    monkeypatch.setenv("ALETSCH_DEVICE_GREEDY", "step")
    if pallas is None:
        monkeypatch.delenv("ALETSCH_PALLAS_GREEDY", raising=False)
    else:
        monkeypatch.setenv("ALETSCH_PALLAS_GREEDY", pallas)
    # the reference builds its step solver once a process and caches its
    # backend per V: start both afresh so this run's backend is used
    monkeypatch.setattr(ref_wave, "_DEVICE", None)
    monkeypatch.setattr(ref_greedy_dp, "_CACHE", {})
    ref_steps0 = ref_wave.stats["device_steps"]
    ref_step = _run(ref_main.main, cohort, tmp_path / "ref_step", "on")
    assert ref_wave.stats["device_steps"] > ref_steps0
    st0 = port_wave.device_stats()
    port_step = _run(port_main.main, cohort, tmp_path / "port_step", "on")
    assert port_step == reference_off
    assert port_step == ref_step
    st = port_wave.device_stats()
    assert st["device_steps"] > st0["device_steps"]
    assert st["dispatches"] > st0.get("dispatches", 0)
    assert st["graphs"] - st0.get("graphs", 0) == \
        st["device_steps"] - st0["device_steps"]
    assert st.get("fused_graphs", 0) == st0.get("fused_graphs", 0)
    assert st["bottleneck_launches"] == 0   # no kernel launch on the CPU


@needs_native
@pytest.mark.parametrize("greedy", [None, "step"])
@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("mode", ["off", "on", "auto"])
@pytest.mark.parametrize("stage,stage_mode", [
    (None, None), ("bridge", "on"), ("bridge", "auto"), ("support", "on"),
    ("support", "auto"), ("ladder", "off"), ("ladder", "on"),
    ("ladder", "auto")])
def test_device_gates_agree(mode, env, greedy, stage, stage_mode,
                            monkeypatch):
    """Parity of the two device gates: the port's incubator launches a
    wave asynchronously on the host exactly where the JAX package's does
    (on a CPU backend), for every greedy mode, fused and step, and for
    every mode of the bridge, support and ladder stages (the first two
    default to off in the gate, the ladder to auto)."""
    for var, val in (("ALETSCH_DEVICE", env),
                     ("ALETSCH_DEVICE_GREEDY", greedy)):
        if val is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, val)
    cfg = default_params()[0]
    cfg.device_greedy = mode
    cfg.device_min_groups = 0
    for s in STAGES:
        setattr(cfg, "device_" + s, stage_mode if s == stage else "off")
    for n_groups in (1, 64):
        assert port_wave.enabled(cfg, n_groups) == \
            ref_wave.enabled(cfg, n_groups)
    for fn in ("bridge_enabled", "support_enabled", "ladder_enabled"):
        assert getattr(port_wave, fn)(cfg) == getattr(ref_wave, fn)(cfg)
    if stage_mode == "on" and env != "0":
        assert port_wave.enabled(cfg, 1) is True


@needs_native
def test_step_mode_engages(monkeypatch):
    cfg = default_params()[0]
    cfg.device_greedy = "on"
    monkeypatch.setenv("ALETSCH_DEVICE_GREEDY", "step")
    assert port_wave.step_mode()
    assert port_wave.enabled(cfg, 4) is True
    # step mode needs the step export only, not the fused one
    monkeypatch.setattr(native_core, "fused_available", lambda: False)
    assert port_wave.enabled(cfg, 4) is True


class _LibWithout:
    """The native library with some entry points hidden."""

    def __init__(self, lib, hidden):
        self._lib, self._hidden = lib, hidden

    def __getattr__(self, name):
        if name in self._hidden:
            raise AttributeError(name)
        return getattr(self._lib, name)


@pytest.mark.parametrize("greedy", [None, "step"])
def test_missing_native_core_raises(greedy, monkeypatch):
    cfg = default_params()[0]
    cfg.device_greedy = "on"
    if greedy is None:
        monkeypatch.delenv("ALETSCH_DEVICE_GREEDY", raising=False)
        monkeypatch.setattr(native_core, "fused_available", lambda: False)
    else:
        monkeypatch.setenv("ALETSCH_DEVICE_GREEDY", greedy)
        lib = _LibWithout(native_core._load_lib(), ("core_greedy_step",))
        monkeypatch.setattr(native_core, "_load_lib", lambda: lib)
    with pytest.raises(RuntimeError, match="native core"):
        port_wave.enabled(cfg, 4)


def test_help_matches_reference(capsys):
    for main in (ref_main.main, port_main.main):
        with pytest.raises(SystemExit) as e:
            main(["--help"])
        assert e.value.code == 0
    ref_out, port_out = capsys.readouterr().out.split("Usage:")[1:]
    assert ref_out == port_out
    assert port_main.main([]) == 0
    assert capsys.readouterr().out == "Usage:" + ref_out


@needs_native
@pytest.mark.parametrize("greedy,stages", [
    (None, ()), ("step", ()), (None, ("bridge", "ladder", "support")),
    ("defaults", ()), (None, ("similarity",))])
def test_cli_runs_with_jax_blocked(greedy, stages, cohort, reference_off,
                                   tmp_path):
    """python -m aletsch_tpu_torch with jax AND the JAX package made
    unimportable, fused, in step mode, fused with the bridge, support and
    ladder stages on, at the CLI's defaults (every device stage on 'auto',
    which stays on the host on the CPU device) and with --device_similarity
    on: exit 0 and the reference's bytes in every output file."""
    out = tmp_path / "nojax"
    (out / "gtf").mkdir(parents=True)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['aletsch_tpu'] = None; "
            "from aletsch_tpu_torch.__main__ import main; "
            "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, ALETSCH_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    env.pop("ALETSCH_DEVICE_GREEDY", None)
    if greedy == "step":
        env["ALETSCH_DEVICE_GREEDY"] = greedy
    defaults = greedy == "defaults"
    flags = ["--max_num_exons", "8"] if defaults else \
        ["--device_greedy", "on", *FORCED]
    if "similarity" in stages:
        flags += ["--device_similarity", "on"]
        stages = ()
    res = subprocess.run(
        [sys.executable, "-c", code, "-i", cohort, "-o",
         str(out / "meta.gtf"), "-d", str(out / "gtf"), *flags,
         *_stage_flags(stages), "--verbose", "1"], cwd=REPO,
        env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = {"meta.gtf": (out / "meta.gtf").read_bytes()}
    for f in sorted(os.listdir(out / "gtf")):
        got[f] = (out / "gtf" / f).read_bytes()
    assert got == reference_off
    device_line = [ln for ln in res.stderr.splitlines()
                   if ln.startswith("[aletsch_tpu_torch] device:")][-1]
    assert ("'dispatches'" in device_line) == (greedy == "step")
    assert ("'fused_graphs'" in device_line) == (greedy is None)
    # every stage left on 'auto' asked the policy, which has no calibration
    # on the CPU device and answered no
    assert ("'calibrated': False" in device_line) == (len(stages) < 3)
    if "'asked'" in device_line:
        answers = device_line.split("'asked'")[1].split("}}}")[0]
        assert "False" in answers and "True" not in answers
    assert ("'ladder_graphs'" in device_line) == bool(stages)
    assert ("'bridge_instances'" in device_line) == bool(stages)


def test_sources_never_import_the_jax_package():
    """No source of the port and no line of chip_smoke.py or bench_torch.py
    imports jax or anything of aletsch_tpu (the package without _torch),
    not even a module there that does not import jax: the port keeps its
    own copy."""
    pkg = os.path.join(REPO, "aletsch_tpu_torch")
    sources = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
               if f.endswith(".py")]
    assert len(sources) >= 50
    for rel in ("ops/meshing.py", "parallel/jaxdist.py",
                "parallel/scaling.py", "graft_entry.py", "io/bam_native.py"):
        assert os.path.join(pkg, rel) in sources, rel
    sources += [os.path.join(REPO, "chip_smoke.py"),
                os.path.join(REPO, "bench_torch.py")]
    banned = re.compile(
        r"^\s*(from|import)\s+(jax|aletsch_tpu)(\.|\s|$)"
        r"|import_module\(\s*['\"](jax|aletsch_tpu)['\".]"
        r"|__import__\(\s*['\"](jax|aletsch_tpu)['\".]")
    for path in sources:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                assert not banned.search(line), "%s:%d: %s" % (
                    path, n, line.strip())
