"""The native wave pool of the device waves (meta/device_wave.py over
csrc/wave_pool.cpp): each region's runs started on the main thread
(device_wave.launch) and each flush's resumes after a solve() advanced
together.  On the CPU device, with every stage forced: the port's CLI in
process at -t 1 (every batch on the calling thread, nothing started early)
and at -t 8, in trust mode, verify mode and step mode, gives every output
file of the host path, and the same work in the same dispatches; the pool's
counters say where the batches went, and its clock that its tasks ran; a
fault planted in a solve() raises from resolve() and leaves no started run
unfreed."""

import collections
import os
import types

import numpy as np
import pytest
import torch

from aletsch_tpu_torch.config import parse_all
from aletsch_tpu_torch.io import bam_native
from aletsch_tpu_torch.meta import device_wave, native_core
from aletsch_tpu_torch.meta.incubator import Incubator
from torch_helpers import output_bytes

FORCED = ["--device_greedy", "on", "--device_bridge", "on",
          "--device_support", "on", "--device_ladder", "on",
          "--device_min_vertices", "2", "--device_min_groups", "0",
          "--max_num_exons", "8", "--verbose", "0"]
MODES = {"trust": {}, "verify": {"ALETSCH_FUSED_TRUST": "0"},
         "step": {"ALETSCH_DEVICE_GREEDY": "step"}}
# the work a run does, which the pool must not change: agreement counts,
# every dispatch count, the instances, graphs and groups each stage took
WORK = ("fused_agree", "fused_total", "ladder_agree", "ladder_total",
        "device_steps", "host_graphs", "device_bridge_insts",
        "host_bridge_insts", "device_support_groups", "host_support_groups",
        "device_ladder_graphs", "host_ladder_graphs", "waves",
        "fused_graphs", "fused_paths", "bridge_instances", "support_groups",
        "ladder_graphs", "ladder_decisions", "graphs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Two adversarial samples (drain, bridge and ladder work) and two
    samples with shared loci (support work): one wave of 18 groups."""
    from aletsch_tpu_torch.sim import (simulate_adversarial_sample,
                                       simulate_sample)
    base = tmp_path_factory.mktemp("pool_cohort")
    lines = []
    for i, seed in enumerate((21, 22)):
        bam = str(base / ("a%d.bam" % i))
        simulate_adversarial_sample(bam, seed=seed, n_loci=5)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    for i, seed in enumerate((41, 42)):
        bam = str(base / ("s%d.bam" % i))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = base / "bams.list"
    lst.write_text("".join(lines))
    return str(lst)


def _pass(lst, out, threads, env=(), flags=FORCED):
    """One pass in process, as the CLI runs it: (output bytes, device stats
    of the pass, groups handed to device waves)."""
    os.makedirs(os.path.join(out, "gtf"))
    groups = []
    assemble = device_wave.assemble_groups

    def counted(asms, *args, **kw):
        groups.append(len(asms))
        return assemble(asms, *args, **kw)
    argv = ["-i", lst, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), "-t", str(threads), *flags]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALETSCH_TORCH_DEVICE", "cpu")
        for k, v in dict(env).items():
            mp.setenv(k, v)
        mp.setattr(device_wave, "assemble_groups", counted)
        device_wave.reset_solvers()         # trust is probed again
        before = dict(device_wave.stats,
                      pool_task_s=device_wave.pool_task_seconds())
        agreed = np.concatenate([native_core.fused_stats,
                                 native_core.ladder_stats])
        inc = Incubator(parse_all(argv))
        try:
            inc.resolve()
        finally:
            if inc._pool is not None:
                inc._pool.shutdown(wait=True)
    stats = device_wave.device_stats()
    for k, v in before.items():
        stats[k] -= v
    for k, v in zip(("fused_agree", "fused_total", "ladder_agree",
                     "ladder_total"), agreed):
        if k in stats:
            stats[k] -= int(v)
    return (output_bytes(os.path.join(out, "meta.gtf"),
                         os.path.join(out, "gtf")), stats, sum(groups))


@pytest.fixture(scope="module")
def host(cohort, tmp_path_factory):
    """The host path's bytes: no device wave."""
    out = str(tmp_path_factory.mktemp("host"))
    files, stats, groups = _pass(cohort, out, 8,
                                 env={"ALETSCH_DEVICE": "0"})
    assert groups == 0 and stats["waves"] == 0
    return files


@pytest.fixture(scope="module")
def runs(cohort, tmp_path_factory):
    """{(mode, threads): pass}, each run once."""
    done = {}

    def get(mode, threads):
        if (mode, threads) not in done:
            out = str(tmp_path_factory.mktemp("%s_t%d" % (mode, threads)))
            done[mode, threads] = _pass(cohort, out, threads, MODES[mode])
        return done[mode, threads]
    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_pool_gives_the_inline_runs_bytes_and_work(mode, runs, host):
    """-t 8 against -t 1: every output file equal, to each other and to the
    host path's, and the same work in the same dispatches."""
    inline, inline_stats, _ = runs(mode, 1)
    pooled, pooled_stats, _ = runs(mode, 8)
    assert len(host) > 1 and len(host["meta.gtf"]) > 0
    assert inline == host
    assert pooled == host
    keys = [k for k in inline_stats
            if k in WORK or k.endswith("dispatches")]
    assert "ladder_dispatches" in keys and "bridge_dispatches" in keys
    assert {k: pooled_stats.get(k) for k in keys} == \
        {k: inline_stats[k] for k in keys}
    for st in (inline_stats, pooled_stats):
        assert st["ladder_agree"] == st["ladder_total"] > 0
        assert st["device_bridge_insts"] > 0
        assert st["device_support_groups"] > 0
        if mode == "step":
            assert st["dispatches"] > 0
        else:
            assert st["fused_agree"] == st["fused_total"] > 0
            assert st["fused_trust"] is (mode == "trust")
        assert st["ladder_trust"] is (mode != "verify")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_the_pool_counts_its_batches(mode, runs):
    """At -t 8 the wave's runs start early and batches of several runs go
    to the pool; at -t 1 every batch runs on the calling thread."""
    _, inline, _ = runs(mode, 1)
    assert inline["pool_calls"] == inline["pool_handles"] == 0
    assert inline["prestarted_groups"] == 0
    assert inline["inline_advances"] > 0
    assert inline["pool_task_s"] > 0
    _, pooled, groups = runs(mode, 8)
    assert groups >= 2
    assert pooled["prestarted_groups"] == groups
    # every batch the pool took held two runs or more
    assert pooled["pool_calls"] > 0
    assert pooled["pool_handles"] >= 2 * pooled["pool_calls"]
    assert pooled["pool_task_s"] > 0


def test_the_pool_width_follows_t_and_the_cores(monkeypatch):
    cfg = types.SimpleNamespace()
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    for t, width in ((1, 0), (2, 1), (8, 7), (10, 7)):
        cfg.max_threads = t
        assert device_wave.pool_width(cfg) == width
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    cfg.max_threads = 10
    assert device_wave.pool_width(cfg) == 0


@pytest.fixture(scope="module")
def regions_cohort(tmp_path_factory):
    """Config 3's generator at 16 genes x 3 samples: several regions, each
    a wave of two to four groups."""
    from aletsch_tpu_torch.cohorts import paired_end_cohort
    lst, _ = paired_end_cohort(str(tmp_path_factory.mktemp("regions")), 16,
                               3)
    return lst


@pytest.mark.parametrize("stage", ["drain", "ladder"])
def test_a_fault_in_a_solve_frees_every_started_run(stage, regions_cohort,
                                                    tmp_path, monkeypatch):
    """A solve() that raises at its second call: resolve() raises it, and
    every run made (the failing wave's, those started early for the
    regions queued behind it) is freed."""
    from aletsch_tpu_torch.ops.greedy_fused import DeviceGreedyFused
    from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
    owner = {"drain": DeviceGreedyFused, "ladder": DeviceLadder}[stage]
    solve = owner.solve
    calls = []

    def planted(self, nrows):
        calls.append(nrows)
        if len(calls) == 2:
            raise RuntimeError("planted %s fault" % stage)
        return solve(self, nrows)
    monkeypatch.setattr(owner, "solve", planted)
    assert native_core.native_core_available()  # argtypes bound first
    lib = bam_native._load_lib()
    made, addrs, freed = [], [], []
    free = lib.core_group_free

    class Counted(native_core.GroupHandle):
        __slots__ = ()

        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)
            addrs.append(self.h)

    def counted_free(h):
        freed.append(h)
        free(h)
    monkeypatch.setattr(native_core, "GroupHandle", Counted)
    monkeypatch.setattr(lib, "core_group_free", counted_free)
    discarded = []
    discard = device_wave.Started.discard

    def counted_discard(self):
        discarded.append(len(self.runs))
        discard(self)
    monkeypatch.setattr(device_wave.Started, "discard", counted_discard)
    with pytest.raises(RuntimeError, match="planted %s fault" % stage):
        _pass(regions_cohort, str(tmp_path / "out"), 8)
    assert len(calls) == 2
    # every run made is freed, once: an address freed may be made again,
    # so the runs' addresses are compared as multisets
    assert made and all(gh.h is None for gh in made)
    assert collections.Counter(addrs) == collections.Counter(freed)
    # the failing wave was started early, and every wave started early
    # and never run was freed with it
    assert discarded and all(discarded)
