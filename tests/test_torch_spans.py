"""The port's spans (utils/tracing.py::Tracer.span) inside the region
pipeline and the device waves, on a small cohort with every stage forced
onto the CPU device (the plain versions): every span of the pipeline's
two threads lands in Tracer.phase_times, the replay thread's spans cover
region assembly, the wave's parts leave a non-negative Python share,
the outputs do not change under a capture, no record_function range is
entered without one, and the port's own capture (--jax_profile_dir)
holds each span as a range on its thread with its region in the args;
the device wave's launch lies inside the region's start.  The solvers'
sync clocks lie inside their solve() clocks.  The card's
check is the cuda-marked test here."""

import glob
import io
import json
import os
import threading

import pytest
import torch

from aletsch_tpu_torch.config import parse_all
from aletsch_tpu_torch.meta import device_wave
from aletsch_tpu_torch.meta.incubator import Incubator
from aletsch_tpu_torch.utils import tracing
from torch_helpers import output_bytes

FORCED = ["--device_greedy", "on", "--device_bridge", "on",
          "--device_support", "on", "--device_ladder", "on",
          "--device_min_vertices", "2", "--device_min_groups", "0",
          "--max_num_exons", "8", "--verbose", "0"]
STAGES = ("drain", "bridge", "support", "ladder")
# the main thread's spans and the replay thread's (clock-only ones last)
MAIN = ("region.start", "region.scan_wait", "region.cluster",
        "region.launch", "region.backpressure")
REPLAY = ("replay.idle", "wave", "wave.start", "wave.round",
          "wave.finish", "replay.fold", "wave.export", "wave.host_dp")
# a stage's solve() clock, its sync clock and its dispatch counter
SYNC = {"drain": ("fused_device_time", "fused_sync_time",
                  "fused_dispatches"),
        "bridge": ("bridge_device_time", "bridge_sync_time",
                   "bridge_dispatches"),
        "ladder": ("ladder_device_time", "ladder_sync_time",
                   "ladder_dispatches")}


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
    samples with shared loci (multi-sample groups: support work), in one
    list: every stage dispatches in the one wave."""
    from aletsch_tpu_torch.sim import (simulate_adversarial_sample,
                                       simulate_sample)
    base = tmp_path_factory.mktemp("spans_cohort")
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


class _Counted(torch.autograd.profiler.record_function):
    """record_function, counting the ranges entered."""
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def _pass(lst, out, *extra):
    """One pass in process, as the CLI runs it: (tracer, device stats,
    output bytes, record_function ranges entered)."""
    os.makedirs(os.path.join(out, "gtf"))
    device_wave.reset_solvers()
    before = dict(device_wave.stats)
    argv = ["-i", lst, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), *FORCED, *extra]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALETSCH_TORCH_DEVICE", "cpu")
        mp.setattr(torch.autograd.profiler, "record_function", _Counted)
        _Counted.entered = 0
        inc = Incubator(parse_all(argv))
        inc.resolve()
        assert inc._pool is not None        # the threaded pipeline
        inc._pool.shutdown(wait=True)
    stats = device_wave.device_stats()
    for k, v in before.items():
        stats[k] -= v
    return (inc.tracer, stats,
            output_bytes(os.path.join(out, "meta.gtf"),
                         os.path.join(out, "gtf")), _Counted.entered)


@pytest.fixture(scope="module")
def plain(cohort, tmp_path_factory):
    return _pass(cohort, str(tmp_path_factory.mktemp("plain")))


@pytest.fixture(scope="module")
def captured(cohort, tmp_path_factory):
    """The same pass under the port's own capture: (pass, trace events)."""
    base = tmp_path_factory.mktemp("captured")
    run = _pass(cohort, str(base / "out"), "--jax_profile_dir",
                str(base / "trace"))
    files = glob.glob(str(base / "trace" / "*.pt.trace.json"))
    assert len(files) == 1, files
    return run, tracing.read_trace(files[0])


def test_the_pipeline_is_threaded_and_every_stage_dispatched(plain):
    _, stats, _, _ = plain
    assert os.cpu_count() > 1
    assert stats["waves"] >= 1
    for stage in STAGES:
        key = "fused_dispatches" if stage == "drain" else \
            stage + "_dispatches"
        assert stats[key] > 0, stage


@pytest.mark.parametrize("name", MAIN + REPLAY + tuple(
    "wave.consume." + s for s in STAGES))
def test_resolve_leaves_the_span_in_phase_times(plain, name):
    tracer = plain[0]
    assert name in tracer.phase_times
    assert tracer.phase_times[name] >= 0.0
    want = {"region.scan_wait": "region.start",
            "region.cluster": "region.start",
            "region.launch": "region.start",
            "wave.start": "wave", "wave.round": "wave",
            "wave.finish": "wave", "wave.export": "wave",
            "wave.host_dp": "wave"}
    if name.startswith("wave.consume."):
        assert tracer.span_parent[name] == "wave.round"
    else:
        assert tracer.span_parent[name] == want.get(name, "assemble-regions")


def test_the_launch_lies_inside_the_region_start(plain, captured):
    """region.launch (the device wave's runs made and handed to the native
    wave pool) lies inside region.start on the main thread: in the clocks,
    and range by range in the capture."""
    pt = plain[0].phase_times
    assert 0.0 < pt["region.launch"] <= pt["region.start"]
    spans = {}
    for e in captured[1]:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X" \
                and e["name"] in ("region.start", "region.launch"):
            spans.setdefault(e["name"], []).append(
                (e["tid"], float(e["ts"]), float(e["ts"]) + e["dur"]))
    assert spans["region.launch"]
    for tid, t0, t1 in spans["region.launch"]:
        assert any(tid == t and s0 <= t0 and t1 <= s1
                   for t, s0, s1 in spans["region.start"])


def test_the_replay_thread_covers_region_assembly(plain):
    """replay.idle + wave + replay.fold: the replay thread's whole time,
    within 5 % of assemble-regions."""
    pt = plain[0].phase_times
    covered = pt["replay.idle"] + pt["wave"] + pt["replay.fold"]
    assert covered <= pt["assemble-regions"]
    assert covered >= 0.95 * pt["assemble-regions"]


def test_the_waves_python_share_is_not_negative(plain):
    """wave less its native calls, exports, host DPs and every solve()."""
    tracer, stats, _, _ = plain
    pt = tracer.phase_times
    native = pt["wave.start"] + pt["wave.finish"] + sum(
        v for k, v in pt.items() if k.startswith("wave.consume."))
    solved = sum(v for k, v in stats.items()
                 if k.endswith("device_time"))
    python = pt["wave"] - native - pt["wave.export"] - pt["wave.host_dp"] \
        - solved
    assert python >= 0.0
    assert pt["wave.round"] >= solved


def test_a_capture_leaves_the_outputs_as_they_are(plain, captured):
    assert captured[0][2] == plain[2]
    assert len(plain[2]) > 1


def test_no_range_is_entered_without_a_capture(plain, captured):
    assert plain[3] == 0
    assert captured[0][3] > 0


def _ranges(events):
    """{name: [(tid, args)]} of the trace's record_function ranges, in
    order of start."""
    out = {}
    for e in sorted(events, key=lambda e: float(e.get("ts", 0.0))):
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            out.setdefault(e["name"], []).append((e["tid"],
                                                  e.get("args", {})))
    return out


@pytest.mark.parametrize("name", ["wave.start", "wave.round",
                                  "wave.consume.*", "region.scan_wait",
                                  "region.launch", "replay.idle"])
def test_the_capture_holds_the_span_with_its_region(captured, name):
    ranges = _ranges(captured[1])
    if name.endswith("*"):
        names = [n for n in ranges if n.startswith(name[:-1])]
        assert {n[len(name) - 1:] for n in names} == set(STAGES)
    else:
        names = [name]
    main = {tid for tid, _ in ranges["region.start"]}
    replay = {tid for tid, _ in ranges["wave"]}
    assert len(main) == 1 and len(replay) == 1 and main != replay
    for n in names:
        got = ranges[n]
        assert got, n
        tids = {tid for tid, _ in got}
        assert tids == (main if n.startswith("region.") else replay), n
        # every range holds a region; replay.idle's last wait (for the
        # end of the queue) holds none
        regions = [args.get("region") for _, args in got]
        if n == "replay.idle":
            assert regions[-1] is None
            regions = regions[:-1]
        assert regions and all(r and r.startswith("chr") and ":" in r
                               for r in regions), (n, regions)


def test_the_capture_joins_one_regions_ranges_across_threads(captured):
    """The wave's region is one that the main thread started."""
    ranges = _ranges(captured[1])
    started = {a["region"] for _, a in ranges["region.start"]}
    waved = {a["region"] for _, a in ranges["wave"]}
    assert waved and waved <= started


@pytest.mark.parametrize("stage", sorted(SYNC))
def test_a_sync_clock_lies_inside_its_solve_clock(plain, stage):
    _, stats, _, _ = plain
    solve, sync, dispatches = SYNC[stage]
    assert stats[dispatches] > 0
    assert 0.0 <= stats[sync] <= stats[solve]
    assert not sync.endswith("device_time")


def test_summary_prints_the_spans_under_their_phase():
    buf = io.StringIO()
    tr = tracing.Tracer(verbose=1, stream=buf)
    with tr.phase("assemble-regions"):
        with tr.span("wave", "chr1:3"):
            with tr.span("wave.round"):
                pass
            tr.add_time("wave.export", 0.25)
    tr.summary()
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[aletsch]   ")]
    assert [ln.split()[1] for ln in lines] == [
        "assemble-regions", "wave", "wave.export", "wave.round"]
    indent = [len(ln) - len(ln[len("[aletsch]"):].lstrip())
              - len("[aletsch]") for ln in lines]
    assert indent == [3, 5, 7, 7]
    assert tr.phase_times["wave.export"] == 0.25


def test_a_span_on_another_thread_nests_under_the_open_phase():
    tr = tracing.Tracer()

    def replay():
        with tr.region("chr2:7"):
            with tr.span("wave"):
                assert tr._stack()[-1] == ("wave", "chr2:7")

    with tr.phase("assemble-regions"):
        t = threading.Thread(target=replay)
        t.start()
        t.join()
    assert tr.span_parent == {"wave": "assemble-regions"}
    assert set(tr.phase_times) == {"assemble-regions", "wave"}


def test_tiled_spans_leave_none_of_the_threads_time_out():
    """A span opened with tile starts its clock where the thread's last
    span closed (or at tile_from's time): the time between two such spans
    counts in the second; a span without it starts its own clock."""
    import time
    tr = tracing.Tracer()
    t0 = time.perf_counter()
    tr.tile_from(t0)
    time.sleep(0.02)
    with tr.span("replay.idle", tile=True):
        pass
    time.sleep(0.02)
    with tr.span("wave", tile=True):
        with tr.span("wave.round"):
            pass
        time.sleep(0.02)
    time.sleep(0.02)
    with tr.span("replay.fold"):
        pass
    whole = time.perf_counter() - t0
    pt = tr.phase_times
    assert pt["replay.idle"] >= 0.02 and pt["wave"] >= 0.04
    assert pt["replay.idle"] + pt["wave"] <= whole - 0.02
    assert pt["wave.round"] < 0.01 and pt["replay.fold"] < 0.01


def test_add_regions_matches_a_threads_ranges_by_name_in_order():
    def rng(tid, name, ts):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "tid": tid, "ts": ts, "dur": 1.0, "args": {}}
    events = [rng(1, "wave", 20.0), rng(1, "wave", 10.0),
              rng(2, "region.start", 5.0), rng(3, "wave.round", 1.0),
              {"ph": "X", "cat": "cpu_op", "name": "wave", "tid": 1,
               "ts": 0.0, "dur": 1.0}]
    entered = [(1, "wave", "chr1:1"), (2, "region.start", "chr1:2"),
               (1, "wave", "chr1:3"), (3, "wave.round", "chr1:4"),
               (3, "wave.round", "chr1:5")]
    tracing.add_regions(events, entered)
    assert [e.get("args", {}).get("region") for e in events] == [
        "chr1:3", "chr1:1", "chr1:2", None, None]


@pytest.mark.cuda
def test_on_the_card_the_clocks_nest(cohort, tmp_path, monkeypatch):
    """On a card: each stage's sync clock and the drain's kernel events
    lie inside its solve() clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cuda")
    device_wave.reset_solvers()
    os.makedirs(str(tmp_path / "gtf"))
    inc = Incubator(parse_all(["-i", cohort, "-o",
                               str(tmp_path / "meta.gtf"), "-d",
                               str(tmp_path / "gtf"), *FORCED]))
    inc.resolve()
    inc._pool.shutdown(wait=True)
    stats = device_wave.device_stats()
    device_wave.reset_solvers()
    for stage, (solve, sync, dispatches) in SYNC.items():
        assert stats[dispatches] > 0, stage
        assert 0.0 < stats[sync] <= stats[solve], stage
    assert 0.0 < stats["fused_kernel_time"] <= stats["fused_device_time"]
    print(json.dumps({k: stats[k] for k in sorted(stats)
                      if k.endswith("_time")}))
