"""The replay thread's merged device waves (meta/incubator.py ReplayQueue
over meta/device_wave.py assemble_groups): the device waves of
the regions queued together, started on the main thread with the same
stage flags, run as one wave of at most one staging batch of groups.  On
the CPU device, with every stage forced, on config 3's generator at 16
genes x 3 samples (five region waves of two to four groups): the port's
CLI in process at -t 8 (merged waves) against -t 1 (no replay thread, no
merging) and against the host path, in trust, verify and step mode, gives
every output file and the same work in fewer dispatches; a fault planted
in a solve() of a merged call raises from resolve() and leaves no started
run unfreed; checkpoints written and loaded give the same bytes; and the
queue's rule, what get() takes and when put() blocks, on hand-made
items."""

import collections
import os
import threading

import numpy as np
import pytest
import torch

from aletsch_tpu_torch.config import parse_all
from aletsch_tpu_torch.io import bam_native
from aletsch_tpu_torch.meta import device_wave, incubator, native_core
from aletsch_tpu_torch.meta.incubator import Incubator, ReplayQueue
from torch_helpers import REPO, output_bytes

FORCED = ["--device_greedy", "on", "--device_bridge", "on",
          "--device_support", "on", "--device_ladder", "on",
          "--device_min_vertices", "2", "--device_min_groups", "0",
          "--max_num_exons", "8", "--verbose", "0"]
MODES = {"trust": {}, "verify": {"ALETSCH_FUSED_TRUST": "0"},
         "step": {"ALETSCH_DEVICE_GREEDY": "step"}}
# the work a run does, which merging must not change: agreement counts,
# the graphs, instances and groups each stage took, the region waves
WORK = ("fused_agree", "fused_total", "ladder_agree", "ladder_total",
        "device_steps", "host_graphs", "device_bridge_insts",
        "host_bridge_insts", "device_support_groups", "host_support_groups",
        "device_ladder_graphs", "host_ladder_graphs", "waves",
        "fused_graphs", "fused_paths", "bridge_instances", "support_groups",
        "ladder_graphs", "ladder_decisions", "graphs")
# each stage's dispatch counter (the greedy stage's by mode)
DISPATCHES = ("bridge_dispatches", "support_dispatches", "ladder_dispatches")
GREEDY = {"trust": "fused_dispatches", "verify": "fused_dispatches",
          "step": "dispatches"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def regions_cohort(tmp_path_factory):
    """Config 3's generator at 16 genes x 3 samples: several regions, each
    a wave of two to four groups."""
    from aletsch_tpu_torch.cohorts import paired_end_cohort
    lst, _ = paired_end_cohort(str(tmp_path_factory.mktemp("regions")), 16,
                               3)
    return lst


class HeldQueue(ReplayQueue):
    """The replay queue, its first get() of a device wave held until a
    second item is queued behind it, so that the passes here merge
    whatever the threads' timing."""

    held = False

    def get(self):
        if not self.held:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._items and (self._items[0][2] is None
                                             or len(self._items) >= 2),
                    timeout=60)
                self.held = bool(self._items) \
                    and self._items[0][2] is not None
        return super().get()


def _pass(lst, out, threads, env=(), extra=()):
    """One pass in process, as the CLI runs it: (output bytes, device stats
    of the pass, for each call of assemble_groups in order its dispatches
    and the number of Started records it was given under "started")."""
    os.makedirs(os.path.join(out, "gtf"), exist_ok=True)
    calls = []
    assemble = device_wave.assemble_groups

    def counted(*args, **kw):
        started = args[4] if len(args) > 4 else kw.get("started")
        before = device_wave.device_stats()
        assemble(*args, **kw)
        after = device_wave.device_stats()
        calls.append({k: after[k] - before.get(k, 0) for k in DISPATCHES
                      + tuple(GREEDY.values()) if k in after})
        calls[-1]["started"] = len(started or ())
    argv = ["-i", lst, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), "-t", str(threads), *FORCED, *extra]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALETSCH_TORCH_DEVICE", "cpu")
        for k, v in dict(env).items():
            mp.setenv(k, v)
        mp.setattr(device_wave, "assemble_groups", counted)
        mp.setattr(incubator, "ReplayQueue", HeldQueue)
        device_wave.reset_solvers()         # trust is probed again
        before = dict(device_wave.stats)
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
                         os.path.join(out, "gtf")), stats, calls)


@pytest.fixture(scope="module")
def host(regions_cohort, tmp_path_factory):
    """The host path's bytes: no device wave."""
    out = str(tmp_path_factory.mktemp("host"))
    files, stats, calls = _pass(regions_cohort, out, 8,
                                env={"ALETSCH_DEVICE": "0"})
    assert not calls and stats["waves"] == 0
    return files


@pytest.fixture(scope="module")
def runs(regions_cohort, tmp_path_factory):
    """{(mode, threads): pass}, each run once; trust mode at -t 8 writes
    its regions' checkpoints into <out>/ckpt."""
    done = {}

    def get(mode, threads):
        if (mode, threads) not in done:
            out = str(tmp_path_factory.mktemp("%s_t%d" % (mode, threads)))
            extra = ["--checkpoint_dir", os.path.join(out, "ckpt")] \
                if (mode, threads) == ("trust", 8) else []
            done[mode, threads] = _pass(regions_cohort, out, threads,
                                        MODES[mode], extra) + (out,)
        return done[mode, threads]
    return get


@pytest.mark.parametrize("mode", sorted(MODES))
def test_merged_waves_give_the_bytes_and_work_in_fewer_dispatches(
        mode, runs, host):
    """-t 8 (merged) against -t 1 and the host path: every output file
    equal, the same work; no stage ships more dispatches, and each stage
    that -t 1 dispatched in two waves or more ships fewer."""
    inline, inline_stats, inline_calls, _ = runs(mode, 1)
    merged, merged_stats, merged_calls, _ = runs(mode, 8)
    assert len(host) > 1 and len(host["meta.gtf"]) > 0
    assert inline == host
    assert merged == host
    keys = [k for k in inline_stats if k in WORK]
    assert "waves" in keys and "ladder_agree" in keys
    assert {k: merged_stats.get(k) for k in keys} == \
        {k: inline_stats[k] for k in keys}
    assert inline_stats["waves"] == len(inline_calls) >= 2
    # -t 1 launches each wave in its call; at -t 8 every call, of one
    # region's wave or more, runs the waves the main thread started
    assert all(c["started"] == 0 for c in inline_calls)
    assert all(c["started"] >= 1 for c in merged_calls)
    assert sum(c["started"] for c in merged_calls) == merged_stats["waves"]
    assert merged_stats["merge_calls"] == \
        sum(c["started"] > 1 for c in merged_calls)
    fewer = []
    for key in DISPATCHES + (GREEDY[mode],):
        assert 0 < merged_stats[key] <= inline_stats[key], key
        if sum(c.get(key, 0) > 0 for c in inline_calls) >= 2:
            assert merged_stats[key] < inline_stats[key], key
            fewer.append(key)
    assert set(DISPATCHES) <= set(fewer)
    assert inline_stats["merge_calls"] == inline_stats["merged_waves"] == 0
    assert merged_stats["merge_calls"] > 0
    assert merged_stats["merged_waves"] >= 2 * merged_stats["merge_calls"]
    assert merged_stats["ladder_agree"] == merged_stats["ladder_total"] > 0
    if mode != "step":
        assert merged_stats["fused_agree"] == merged_stats["fused_total"] > 0


def test_checkpoints_written_and_loaded_give_the_bytes(runs, host,
                                                       regions_cohort,
                                                       tmp_path):
    """The trust pass at -t 8 wrote every region's checkpoint; a pass with
    every third region's kept (each load ends a merge: its item is queued
    alone) and one with all of them loaded give its bytes."""
    files, stats, _, out = runs("trust", 8)
    assert files == host
    ckpt = os.path.join(out, "ckpt")
    names = sorted(os.listdir(ckpt), key=lambda f: (
        f.rsplit("_", 1)[0], int(f.rsplit("_", 1)[1].split(".")[0])))
    assert len(names) >= 3 and all(f.endswith(".pkl") for f in names)
    for i, f in enumerate(names):
        if i % 3:
            os.remove(os.path.join(ckpt, f))
    extra = ["--checkpoint_dir", ckpt]
    mixed, mixed_stats, _ = _pass(regions_cohort, str(tmp_path / "mixed"),
                                  8, extra=extra)
    assert mixed == host
    assert 0 < mixed_stats["waves"] < stats["waves"]
    assert mixed_stats["merged_waves"] <= mixed_stats["waves"]
    assert sorted(os.listdir(ckpt)) == sorted(names)
    loaded, loaded_stats, calls = _pass(regions_cohort,
                                        str(tmp_path / "loaded"), 8,
                                        extra=extra)
    assert loaded == host
    assert loaded_stats["waves"] == 0 and not calls


@pytest.mark.parametrize("stage", ["ladder", "bridge", "support"])
def test_a_fault_in_a_merged_solve_frees_every_started_run(
        stage, regions_cohort, tmp_path, monkeypatch):
    """A solve() that raises at its first call inside a merged call (each
    of these stages dispatches in every wave of the cohort): resolve()
    raises it, every run made is freed, and every wave of the merged call
    is discarded."""
    from aletsch_tpu_torch.ops.bridge_topk import DeviceBridge
    from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
    from aletsch_tpu_torch.ops.support import DeviceSupport
    owner = {"ladder": DeviceLadder, "bridge": DeviceBridge,
             "support": DeviceSupport}[stage]
    solve = owner.solve
    current = []                # the Started records of the call running
    merged = []                 # those of the merged call that failed

    def planted(self, nrows):
        if len(current) > 1:
            merged.extend(current)
            raise RuntimeError("planted %s fault" % stage)
        return solve(self, nrows)
    monkeypatch.setattr(owner, "solve", planted)
    assemble = device_wave.assemble_groups

    def watched(asms, gvs, cfg, tracer=None, started=None):
        current[:] = started or []
        return assemble(asms, gvs, cfg, tracer, started)
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
        discarded.append(self)
        discard(self)
    monkeypatch.setattr(device_wave.Started, "discard", counted_discard)
    # _pass wraps the module's assemble_groups in turn
    monkeypatch.setattr(device_wave, "assemble_groups", watched)
    with pytest.raises(RuntimeError, match="planted %s fault" % stage):
        _pass(regions_cohort, str(tmp_path / "out"), 8)
    assert len(merged) >= 2
    # every run made is freed, once: an address freed may be made again,
    # so the runs' addresses are compared as multisets
    assert made and all(gh.h is None for gh in made)
    assert collections.Counter(addrs) == collections.Counter(freed)
    assert all(any(st is d for d in discarded) for st in merged)
    assert all(st.job is None and st.keep is None for st in merged)


# ----------------------------------------------------- the queue's own rule
FLAGS = (True, True, True)
OTHER = (True, False, True)


def _get_soon(q, timeout=5.0):
    """q.get() on another thread: its items, or None where it blocks."""
    out = []
    t = threading.Thread(target=lambda: out.append(q.get()), daemon=True)
    t.start()
    t.join(timeout)
    return out[0] if out else None


def test_a_merged_call_is_one_staging_batch_of_every_stage():
    """MERGE_GROUPS is no larger than any stage's batch as its solver is
    built, so a round of a merged call ships one dispatch a stage."""
    from aletsch_tpu_torch.ops import bridge_topk, constants, ladder_kernel
    from aletsch_tpu_torch.ops import support
    batches = (constants.DRAIN_B, constants.STEP_B, bridge_topk.DEFAULT_B,
               support.DEFAULT_B, ladder_kernel.DEFAULT_B)
    assert device_wave.MERGE_GROUPS == min(batches) == 64
    assert device_wave.merges(FLAGS, 60, FLAGS, 4)
    assert not device_wave.merges(FLAGS, 60, FLAGS, 5)
    assert not device_wave.merges(FLAGS, 3, OTHER, 3)


def test_get_takes_the_waves_queued_with_the_same_flags_within_a_batch():
    q = ReplayQueue(16)     # no put blocks here
    q.put("a", 3, FLAGS)
    q.put("b", 4, FLAGS)
    q.put("c", 3, OTHER)            # other flags end a merge
    q.put("d", 2, OTHER)
    q.put("ckpt")                   # so does an item that is no wave
    q.put("e", 60, FLAGS)
    q.put("f", 5, FLAGS)            # 65 groups: over the batch
    q.put("g", 80, FLAGS)           # a wave over the batch goes alone
    q.put("h", 1, FLAGS)
    q.put("host")                   # a host-path region is no wave
    q.put("i", 1, FLAGS)
    assert [q.get() for _ in range(8)] == [
        ["a", "b"], ["c", "d"], ["ckpt"], ["e"], ["f"], ["g"], ["h"],
        ["host"]]
    # never waits for a wave not yet queued
    assert _get_soon(q) == ["i"]
    assert q._groups == 0


def test_get_takes_up_to_a_staging_batch_of_groups():
    q = ReplayQueue(2)
    for i in range(22):
        q.put(i, 3, FLAGS)
    assert q.get() == list(range(21))       # 63 groups; 66 is over 64
    assert q.get() == [21]
    q.put("x", 32, FLAGS)
    q.put("y", 32, FLAGS)
    assert q.get() == ["x", "y"]            # exactly one batch


def test_put_blocks_on_two_batches_of_groups_and_the_depth():
    q = ReplayQueue(2)
    for i in range(43):                     # 129 groups in 43 waves
        q.put(i, 3, FLAGS)
    blocked = threading.Thread(target=q.put, args=("late", 3, FLAGS),
                               daemon=True)
    blocked.start()
    blocked.join(0.5)
    assert blocked.is_alive()
    assert q.get() == list(range(21))       # 66 groups left
    blocked.join(5.0)
    assert not blocked.is_alive()
    # below the depth a put never blocks, whatever the groups
    q = ReplayQueue(3)
    q.put("big", 200, FLAGS)
    q.put("host")
    done = threading.Thread(target=q.put, args=("third", 500, FLAGS),
                            daemon=True)
    done.start()
    done.join(5.0)
    assert not done.is_alive()
    # items that are no wave weigh a batch each: the depth holds as before
    q = ReplayQueue(2)
    q.put("r1")
    q.put("r2")
    blocked = threading.Thread(target=q.put, args=("r3",), daemon=True)
    blocked.start()
    blocked.join(0.5)
    assert blocked.is_alive()
    assert q.get() == ["r1"]
    blocked.join(5.0)
    assert not blocked.is_alive()


def test_join_waits_for_every_item_taken_to_be_done():
    q = ReplayQueue(2)
    q.put("a", 3, FLAGS)
    q.put("b", 3, FLAGS)
    items = q.get()
    joined = threading.Thread(target=q.join, daemon=True)
    joined.start()
    joined.join(0.3)
    assert joined.is_alive()
    q.task_done(len(items))
    joined.join(5.0)
    assert not joined.is_alive()


def test_the_merge_width_metric_reads_the_counters(monkeypatch):
    """benchmark/metrics/wave.merge_width.py: merged_waves / merge_calls a
    pass, the mean over the passes; silent where no call merged."""
    import importlib.util
    import types
    bench = os.path.join(REPO, "benchmark")
    monkeypatch.syspath_prepend(bench)
    spec = importlib.util.spec_from_file_location(
        "metric_wave_merge_width",
        os.path.join(bench, "metrics", "wave.merge_width.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def run(*stats):
        return types.SimpleNamespace(passes=[
            types.SimpleNamespace(stats=s, error=None) for s in stats])
    assert mod.read(run({"merge_calls": 4, "merged_waves": 40},
                        {"merge_calls": 2, "merged_waves": 10})) == 7.5
    assert mod.read(run({"merge_calls": 0, "merged_waves": 0},
                        {"merge_calls": 1, "merged_waves": 3})) == 3.0
    assert mod.read(run({"merge_calls": 0, "merged_waves": 0})) is None
    assert mod.read(run({"pool_calls": 3})) is None      # no merging
