#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (aletsch_tpu_torch), the port's
counterpart of bench.py.

    python3 bench_torch.py [--config 3|4|5] [--mode MODE] [--reps N]
        [--seed S] [--genes N] [--samples N] [--detail PATH] [--probes]
        [--sweep]

A cell is one configuration of BASELINE.json under one mode of the port's
CLI.  The configurations (aletsch_tpu_torch/cohorts.py builds them from
--seed, each builder's own seed by default, and caches them in the
temporary directory, keyed by config, genes, samples and seed):

  3  2000 genes x 10 paired-end samples (paired_end_cohort)
  4  2000 genes x 10 samples, PacBio CCS and ONT in turn (long_read_cohort)
  5  1000 genes x 64 smart-seq cells (smartseq_cohort)

--genes and --samples cut a configuration (the cuts are listed under
"reduced").  The modes, every one at --max_num_exons 8 (MODES):

  host      ALETSCH_DEVICE=0 at the CLI's defaults: nothing on the card
  defaults  the CLI's defaults, every stage on 'auto', in a temporary
            directory of the cell's own: the first rep measures the
            policy's calibration if a stage asks, the later reps read it
  fused     the drain forced onto the card, the other stages off
  step      as fused, in step mode (ALETSCH_DEVICE_GREEDY=step): the
            bottleneck kernel in place of the drain
  all       the drain, bridge, support and ladder forced, trust mode

Default: --config 3 --mode all --reps 3.  --sweep runs configs 3, 4 and 5
under host, defaults, fused and all, and config 3 under step.

A cell runs the port's CLI (python -m aletsch_tpu_torch, jax and
aletsch_tpu made unimportable in its processes) and the reference's
(python -m aletsch_tpu --device_greedy off --max_num_exons 8) --reps
times each, as subprocesses in turns (reference, port, port, reference,
...) in one window, and the upstream binary (tools/refbuild/build/aletsch
-t 10) beside the reference where it exists or can be built.  Every
output file of every port run must equal the reference's byte for byte.
Then, outside the timed reps: one more port run traced with
--jax_profile_dir (device time by kernel; the device's idle share over
the capture, 1 - the union of the device records' intervals over the
capture's window, and over the wall; the tracing overhead, the traced wall
less the untraced median; one device record for each kernel, copy and
memset queued, or the run fails), and one run of the host path in this
process for the bundle count of the headline rate and the resolution
ladder's histogram.  Set-up is its own metric: the builds made before
the first run (native/ for both CLIs, the kernels on a card), `import
torch` (and on a card the CUDA context) timed in a child, and the
calibration's seconds in each rep of the defaults (0.0 where a rep read
the file an earlier one wrote, null where no stage asked).
--probes adds, to the detail file only, the policy's and the roofline's
measurements, the scaling shape, a --jax_dist_launch 2 run and the small
and deep workloads in process.

The device is ALETSCH_TORCH_DEVICE's (default cuda).  Asked for cuda with
no card, the script exits 1 before any run.  With cpu every kernel runs
its plain version and every device time is null (not measured).

The last line of stdout is one compact JSON object (under 2,000 bytes):
bundles_per_second of the port's median wall, the walls, vs_baseline
(the port's rate over the reference's in the same window, 0.0 without
one), correct, the idle share, set-up, each stage's launches, dispatches
and kernel ms, the device, and the detail file, which holds every table
(BENCH_TORCH_DETAIL.json beside this script, or --detail PATH).  The
children's output goes to a run.log beside each run's outputs.  This
script imports neither jax nor aletsch_tpu.  Exit 0; 1 when an output
differs, a run or a probe fails, or the card is missing; 2 on bad usage.
"""

import ast
import glob
import json
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from aletsch_tpu_torch.utils.tracing import (DEVICE_CATS, device_counts,
                                             read_trace)

REPO = os.path.dirname(os.path.abspath(__file__))
DETAIL = "BENCH_TORCH_DETAIL.json"
# config -> (cohorts.py builder, genes, samples)
CONFIGS = {3: ("paired_end", 2000, 10), 4: ("long_read", 2000, 10),
           5: ("smartseq", 1000, 64)}
MODES = ("host", "defaults", "fused", "step", "all")
SWEEP = [(c, m) for c in (3, 4, 5) for m in ("host", "defaults", "fused",
                                             "all")] + [(3, "step")]
COHORT_JOBS = 8
BINARY = os.path.join(REPO, "tools", "refbuild", "build", "aletsch")
STATS_PREFIX = "[aletsch_tpu_torch] device:"
# stage -> (dispatches, kernel launches, solve()'s host clock in s, the
# kernel's CUDA events in s, the kernel's name in a trace); None: the
# stage has none (support runs as plain PyTorch; the drain and the
# bottleneck keep no event clock, so the trace gives their kernel time)
STAGES = {
    "drain": ("fused_dispatches", "drain_launches", "fused_device_time",
              None, "drain_kernel"),
    "bottleneck": ("dispatches", "bottleneck_launches", "device_time", None,
                   "bottleneck_kernel"),
    "bridge": ("bridge_dispatches", "bridge_launches", "bridge_device_time",
               "bridge_kernel_time", "bridge_kernel"),
    "support": ("support_dispatches", None, "support_device_time", None,
                None),
    "ladder": ("ladder_dispatches", "ladder_launches", "ladder_device_time",
               "ladder_kernel_time", "ladder_kernel")}
IMPORT_TORCH = """import time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
ctx = None
if {cuda}:
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ctx = time.perf_counter() - t1
print(t1 - t0, ctx)
"""


class BenchFailure(Exception):
    pass


def log(msg):
    print("[bench_torch] %s" % msg, file=sys.stderr, flush=True)


def _smoke():
    """chip_smoke.py, whose flag lists and output comparison this script
    shares.  Imported only to run: it makes jax and aletsch_tpu
    unimportable in the process that imports it."""
    import chip_smoke
    return chip_smoke


def _median(xs):
    return statistics.median(xs) if xs else None


def mode_flags(mode):
    """(CLI flags, environment) of the port's CLI in `mode`, or of the
    JAX package's reference run with mode "reference"."""
    s = _smoke()
    flags, env = {
        "reference": (s.HOST_ARGS, {}),
        "host": (s.DEFAULT_ARGS, {"ALETSCH_DEVICE": "0"}),
        "defaults": (s.DEFAULT_ARGS, {}),
        "fused": (s.DEVICE_ARGS, {}),
        "step": (s.DEVICE_ARGS, {"ALETSCH_DEVICE_GREEDY": "step"}),
        "all": (s.DEVICE_ARGS + s.BRIDGE_SUPPORT_ARGS + s.LADDER_ARGS, {}),
    }[mode]
    # the port prints its device stats line at --verbose 1
    return (list(flags) + (["--verbose", "1"] if mode != "reference"
                           else []), env)


def parse_stats(text):
    """The device stats of the last "[aletsch_tpu_torch] device: {...}"
    line of a CLI's stderr, or None."""
    found = None
    for line in text.splitlines():
        if line.startswith(STATS_PREFIX):
            found = ast.literal_eval(line[len(STATS_PREFIX):].strip())
    return found


def device_busy_us(events):
    """The time (us) in which the card held at least one of a trace's
    device records: the union of their intervals, so overlapping records
    count once; host records are ignored."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def capture_window_us(events):
    """The duration (us) of a torch.profiler trace's capture."""
    span = [e for e in events if e.get("cat") == "Trace"]
    if len(span) != 1:
        raise BenchFailure("the trace holds %d capture spans" % len(span))
    return float(span[0]["dur"])


def idle_share(events, window_us=None):
    """1 - the device's busy time over the window (the capture's by
    default)."""
    window = capture_window_us(events) if window_us is None else window_us
    return 1.0 - device_busy_us(events) / window


def kernel_times(events):
    """{record name: [count, ms]} of a trace's device records."""
    by = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            c, ms = by.get(e["name"], (0, 0.0))
            by[e["name"]] = [c + 1, ms + float(e.get("dur", 0.0)) / 1e3]
    return by


# ------------------------------------------------------------- cohorts
def cohort(config, genes, samples, seed):
    """(bams.list, records) of a configuration's cohort, built once into
    the temporary directory and read back from there later."""
    from aletsch_tpu_torch import cohorts
    kind = CONFIGS[config][0]
    base = os.path.join(tempfile.gettempdir(), "aletsch_bench_torch",
                        "c%d_g%d_s%d_seed%d" % (config, genes, samples, seed))
    made = os.path.join(base, "cohort.json")
    if os.path.exists(made):
        with open(made) as fh:
            j = json.load(fh)
        return j["list"], j["records"]
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    lst, n = cohorts.BUILDERS[kind](base, genes, samples, seed=seed,
                                    jobs=min(COHORT_JOBS, os.cpu_count()))
    with open(made, "w") as fh:
        json.dump({"list": lst, "records": n}, fh)
    log("config %d cohort (%s, %d genes x %d samples, seed %d): %d records "
        "in %.1f s" % (config, kind, genes, samples, seed, n,
                       time.perf_counter() - t0))
    return lst, n


def default_seed(config):
    from aletsch_tpu_torch import cohorts
    return {3: cohorts.PAIRED_END_SEED, 4: cohorts.LONG_READ_SEED,
            5: cohorts.SMARTSEQ_SEED}[config]


def warm(lst):
    """Read every BAM once, so no timed run pays a cold page cache."""
    with open(lst) as fh:
        bams = [line.split()[0] for line in fh if line.strip()]
    for b in bams:
        with open(b, "rb") as fh:
            while fh.read(1 << 22):
                pass


# ---------------------------------------------------------------- runs
def run_cli(module, lst, mode, out, env, extra=()):
    """One CLI subprocess of `module` in `mode` (mode_flags), its output
    under out and its stdout and stderr in out/run.log.  Returns {"wall_s",
    "cpu_s", "stats" (the device stats line, None if not printed),
    "out"}."""
    flags, menv = mode_flags(mode)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    argv = [sys.executable, "-m", module, "-i", lst,
            *_smoke()._cli_args(out), *flags, *extra]
    logpath = os.path.join(out, "run.log")
    r0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    with open(logpath, "w") as fh:
        rc = subprocess.run(argv, cwd=REPO, env=dict(env, **menv),
                            stdout=fh, stderr=fh, timeout=3600).returncode
    wall = time.perf_counter() - t0
    r1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    with open(logpath) as fh:
        text = fh.read()
    if rc != 0:
        raise BenchFailure("python -m %s (%s) exited %d: %s"
                           % (module, mode, rc, text[-2000:]))
    return {"wall_s": wall, "out": out, "stats": parse_stats(text),
            "cpu_s": (r1.ru_utime - r0.ru_utime)
            + (r1.ru_stime - r0.ru_stime)}


def upstream_binary(work):
    """The upstream binary, built by tools/refbuild/compare.py::
    ensure_binary (in a child, its output to a log) where it is missing;
    None where it cannot be."""
    if not os.path.exists(BINARY):
        with open(os.path.join(work, "binary_build.log"), "w") as fh:
            subprocess.run(
                [sys.executable, "-c", "from tools.refbuild.compare import "
                 "ensure_binary; ensure_binary()"], cwd=REPO, stdout=fh,
                stderr=fh, env=dict(os.environ, PYTHONPATH=REPO),
                timeout=1800)
    return BINARY if os.access(BINARY, os.X_OK) else None


def run_binary(binary, lst, out):
    """The upstream binary's wall with -t 10, retried once when it crashes
    (its 10-thread run sometimes dies of SIGSEGV); None if both fail."""
    for attempt in range(2):
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(os.path.join(out, "gtf"))
        t0 = time.perf_counter()
        with open(os.path.join(out, "run.log"), "w") as fh:
            rc = subprocess.run(
                [binary, "-i", lst, "-o", os.path.join(out, "meta.gtf"),
                 "-d", os.path.join(out, "gtf"), "-t", "10"], stdout=fh,
                stderr=subprocess.STDOUT, timeout=3600).returncode
        if rc == 0:
            return time.perf_counter() - t0
        log("the upstream binary exited %d (attempt %d)" % (rc, attempt))
    return None


def traced_run(lst, mode, out, env, on_card):
    """One port run with --jax_profile_dir, outside the timed reps.  Its
    trace must hold one device record for each kernel, copy and memset
    queued.  Returns the run with its trace's numbers."""
    trace_dir = out + "_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    run = run_cli("aletsch_tpu_torch", lst, mode, out, env,
                  extra=("--jax_profile_dir", trace_dir))
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise BenchFailure("the traced run left %d trace files" % len(files))
    events = read_trace(files[0])
    counts = device_counts(events)
    records = sum(counts[c] for c in DEVICE_CATS)
    if records != counts["enqueued"]:
        raise BenchFailure("the trace holds %d device records for %d "
                           "kernels, copies and memsets queued"
                           % (records, counts["enqueued"]))
    window = capture_window_us(events)
    busy = device_busy_us(events)
    by = kernel_times(events)
    run.update({
        "trace_bytes": os.path.getsize(files[0]), "events": len(events),
        "counts": counts, "records": records, "capture_s": window / 1e6,
        "busy_ms": busy / 1e3 if on_card else None,
        "idle_share": idle_share(events, window) if on_card else None,
        "idle_share_wall": 1.0 - busy / 1e6 / run["wall_s"]
        if on_card else None,
        "by_kernel": dict(sorted(by.items(), key=lambda kv: -kv[1][1])[:16])
        if on_card else None})
    shutil.rmtree(trace_dir, ignore_errors=True)
    return run


def in_process_host_run(lst, out):
    """The host path (ALETSCH_DEVICE=0, the reference's flags) in this
    process: the bundle count, the transcripts and the resolution
    ladder's histogram of rung fires (the device ladder covers rungs
    0-3)."""
    from aletsch_tpu_torch.config import parse_all
    from aletsch_tpu_torch.meta import native_core
    from aletsch_tpu_torch.meta.incubator import Incubator
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    params = parse_all(["-i", lst, *_smoke()._cli_args(out),
                        *mode_flags("reference")[0]])
    native_core.ladder_histogram(reset=True)
    old = os.environ.get("ALETSCH_DEVICE")
    os.environ["ALETSCH_DEVICE"] = "0"
    try:
        inc = Incubator(params)
        t0 = time.perf_counter()
        inc.resolve()
        wall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("ALETSCH_DEVICE")
        else:
            os.environ["ALETSCH_DEVICE"] = old
    hist = native_core.ladder_histogram()
    prefix = sum(hist[k] for k in native_core.LADDER_RUNGS[:4]) if hist \
        else None
    total = sum(hist.values()) if hist else None
    with open(os.path.join(out, "meta.gtf")) as fh:
        n_trst = sum(1 for line in fh if "\ttranscript\t" in line)
    return {"wall_s": wall, "bundles": inc.stats["bundles"],
            "transcripts": n_trst, "ladder_fires": hist,
            "device_prefix_share": prefix / total if total else None}


def prepare(work, on_card):
    """Build before any timed run what a first run would build: the
    reference's native/libabam.so, the port's native core and, on a card,
    the kernels.  Returns the seconds it took."""
    from aletsch_tpu_torch.meta import device_wave
    t0 = time.perf_counter()
    with open(os.path.join(work, "native_build.log"), "w") as fh:
        subprocess.run(["make", "-s", "-C", os.path.join(REPO, "native")],
                       stdout=fh, stderr=fh, check=True, timeout=1800)
    device_wave.require_native()
    if on_card:
        from aletsch_tpu_torch.ops import _build
        _build.build()
    return time.perf_counter() - t0


def setup_times(env, on_card):
    """`import torch` (and on a card the CUDA context) in a child, in s."""
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_TORCH.format(cuda=on_card)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600, check=True)
    imp, ctx = res.stdout.split()[-2:]
    return {"import_torch_s": float(imp),
            "cuda_context_s": None if ctx == "None" else float(ctx)}


def stage_table(stats, trace, on_card):
    """{stage: dispatches, launches, solve_ms, event_ms, kernel_ms}: the
    counts and the kernel's device time from the traced run (its stats and
    its records, one process), the host clocks from the median timed run's
    `stats` (the profiler slows the host); the times null off the card.
    The traced run comes after the timed reps, so at the defaults it reads
    the calibration and launches nothing to measure one."""
    stats, counts = stats or {}, trace["stats"] or {}
    out = {}
    for stage, (disp, launch, solve, events, kernel) in STAGES.items():
        row = {"dispatches": counts.get(disp, 0),
               "launches": counts.get(launch, 0) if launch else None,
               "solve_ms": None, "event_ms": None, "kernel_ms": None}
        if on_card:
            row["solve_ms"] = stats.get(solve, 0.0) * 1e3
            if events:
                row["event_ms"] = stats.get(events, 0.0) * 1e3
            if kernel:
                row["kernel_ms"] = sum(
                    ms for name, (_, ms) in trace["by_kernel"].items()
                    if kernel in name)
        out[stage] = row
    return out


def _same(smoke, got_dir, ref, what, mismatches):
    try:
        smoke._require_same(smoke._outputs(got_dir), ref, what)
    except smoke.SmokeFailure as e:
        mismatches.append(str(e))


def cell(config, mode, reps, seed, genes, samples, work, env, on_card,
         binary):
    """One configuration under one mode (module docstring).  Returns the
    cell's record."""
    smoke = _smoke()
    lst, records = cohort(config, genes, samples, seed)
    warm(lst)
    tag = "c%d_%s" % (config, mode)
    port_env = dict(smoke._child_env(work, env),
                    ALETSCH_TORCH_DEVICE=env.get("ALETSCH_TORCH_DEVICE",
                                                 "cuda"))
    cache_dir = None
    if mode == "defaults":
        # a temporary directory of the cell's own: no calibration of an
        # earlier run is read
        cache_dir = tempfile.mkdtemp(prefix=tag + "_tmp_", dir=work)
        port_env["TMPDIR"] = cache_dir
    ref, port, binary_walls, calibration = [], [], [], []
    mismatches = []
    ref_out = None
    for r in range(reps):
        for side in (("ref", "port") if r % 2 == 0 else ("port", "ref")):
            out = os.path.join(work, "%s_%s%d" % (tag, side, r))
            if side == "ref":
                ref.append(run_cli("aletsch_tpu", lst, "reference", out, env))
                if ref_out is None:
                    ref_out = smoke._outputs(out)
                _same(smoke, out, ref_out, "reference run %d" % r,
                      mismatches)
                if binary:
                    binary_walls.append(run_binary(
                        binary, lst, os.path.join(work, "%s_binary%d"
                                                  % (tag, r))))
                continue
            cached = bool(cache_dir and glob.glob(os.path.join(
                cache_dir, "aletsch_torch_crossover_*")))
            run = run_cli("aletsch_tpu_torch", lst, mode, out, port_env)
            port.append(run)
            # every rep's turn starts with the reference on rep 0
            _same(smoke, out, ref_out, "port run %d" % r, mismatches)
            auto = (run["stats"] or {}).get("auto") or {}
            calibration.append(
                None if not auto.get("calibrated") else
                0.0 if cached else auto.get("measured_in_s"))
    walls = [p["wall_s"] for p in port]
    ref_walls = [p["wall_s"] for p in ref]
    wall = _median(walls)
    out = os.path.join(work, tag + "_traced")
    trace = traced_run(lst, mode, out, port_env, on_card)
    _same(smoke, out, ref_out, "the traced port run", mismatches)
    trace["overhead_s"] = trace["wall_s"] - wall
    out = os.path.join(work, tag + "_inprocess")
    inproc = in_process_host_run(lst, out)
    _same(smoke, out, ref_out, "the in-process host run", mismatches)
    median_run = min(port, key=lambda p: abs(p["wall_s"] - wall))
    bundles = inproc["bundles"]
    ref_wall = _median(ref_walls)
    full = CONFIGS[config]
    binary_ok = [w for w in binary_walls if w is not None]
    res = {
        "config": config, "mode": mode, "seed": seed, "genes": genes,
        "samples": samples,
        "reduced": [c for c in (
            "genes %d of %d" % (genes, full[1]) if genes != full[1] else "",
            "samples %d of %d" % (samples, full[2])
            if samples != full[2] else "") if c],
        "records": records, "bundles": bundles,
        "value": bundles / wall, "ref_value": bundles / ref_wall,
        "vs_baseline": ref_wall / wall,
        "wall_s": wall, "wall_s_min": min(walls), "wall_s_max": max(walls),
        "n": len(walls), "wall_s_runs": walls,
        "cpu_s_runs": [p["cpu_s"] for p in port],
        "ref_wall_s": ref_wall, "ref_wall_s_min": min(ref_walls),
        "ref_wall_s_max": max(ref_walls), "ref_wall_s_runs": ref_walls,
        "ref_cpu_s_runs": [p["cpu_s"] for p in ref],
        "binary_wall_s": _median(binary_ok),
        "binary_wall_s_runs": binary_walls if binary else None,
        "correct": not mismatches, "mismatches": mismatches,
        "files": len(ref_out),
        "calibration_s_runs": calibration,
        "stages": stage_table(median_run["stats"], trace, on_card),
        "stats_runs": [p["stats"] for p in port],
        "trace": {k: v for k, v in trace.items() if k != "out"},
        "inprocess": inproc}
    log("config %d %s: port %.3f s [%.3f-%.3f] (n %d), reference %.3f s, "
        "vs_baseline %.3f, correct %s, idle share %s"
        % (config, mode, wall, min(walls), max(walls), len(walls), ref_wall,
           res["vs_baseline"], res["correct"], trace["idle_share"]))
    for m in mismatches:
        log("  DIFFERS: %s" % m)
    return res


# -------------------------------------------------------------- probes
def make_workload(tmpdir, deep=False):
    """bench.py's small (30 genes x 2 samples) or deep (20 genes x 2
    samples, 400 pairs a gene) workload, written with the port's
    simulator.  Returns (bams.list, read records)."""
    import random

    from aletsch_tpu_torch.sim import simulate_pairs, write_bam
    rng = random.Random(11 if deep else 7)
    genes, pos = [], 100000
    for _ in range(20 if deep else 30):
        exons, p = [], pos
        for _ in range(rng.randint(2, 6 if deep else 5)):
            el = rng.randint(150, 500)
            exons.append((p, p + el))
            p += el + rng.randint(400, 2000)
        genes.append(exons)
        pos = p + rng.randint(30000, 60000)
    bams, nreads = [], 0
    for s in range(2):
        recs = []
        for gi, exons in enumerate(genes):
            strand = "+" if gi % 2 == 0 else "-"
            if deep:
                recs += simulate_pairs(exons, 400, strand, rng,
                                       prefix="d%dg%d" % (s, gi))
                continue
            n = rng.randint(30, 80)
            recs += simulate_pairs(exons, n, strand, rng,
                                   prefix="s%dg%d" % (s, gi))
            if len(exons) >= 3:
                recs += simulate_pairs(exons[:1] + exons[2:], max(8, n // 3),
                                       strand, rng, prefix="s%dk%d" % (s, gi))
        nreads += len(recs)
        path = os.path.join(tmpdir, "%s%d.bam" % ("deep" if deep else "s", s))
        write_bam(path, recs, names=("chr1",), lengths=(40_000_000,))
        bams.append(path)
    lst = os.path.join(tmpdir, "deep.list" if deep else "bams.list")
    with open(lst, "w") as fh:
        for b in bams:
            fh.write("%s %s.bai paired_end\n" % (b, b))
    return lst, nreads


def run_pipeline(tmpdir, lst, sub, reps=3):
    """bench.py::run_pipeline in this process at the CLI's defaults: the
    best of reps walls, the bundles and transcripts."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.meta.incubator import Incubator
    out = os.path.join(tmpdir, sub)
    os.makedirs(os.path.join(out, "gtf"), exist_ok=True)
    params = default_params()
    for p in params:
        p.input_bam_list = lst
        p.output_gtf_file = os.path.join(out, "meta.gtf")
        p.output_gtf_dir = os.path.join(out, "gtf")
        p.verbose = 0
    best = None
    for _ in range(reps):
        inc = Incubator(params)
        t0 = time.perf_counter()
        inc.resolve()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    with open(os.path.join(out, "meta.gtf")) as fh:
        n_trst = sum(1 for line in fh if "\ttranscript\t" in line)
    return {"bundles": inc.stats["bundles"], "best_wall_s": best,
            "transcripts": n_trst}


def probes(work, lst, ref_dir, env):
    """The measurements of bench.py's probes, on the port's device, each
    {"error": ...} if it fails."""
    from aletsch_tpu_torch.ops import crossover, mfu
    from aletsch_tpu_torch.parallel import scaling
    smoke = _smoke()

    def jax_dist():
        out = os.path.join(work, "probe_jax_dist")
        run = run_cli("aletsch_tpu_torch", lst, "fused", out,
                      smoke._child_env(work, env) | {
                          "ALETSCH_TORCH_DEVICE": env.get(
                              "ALETSCH_TORCH_DEVICE", "cuda")},
                      extra=("--jax_dist_launch", "2"))
        smoke._require_same(smoke._outputs(out), smoke._outputs(ref_dir),
                            "the --jax_dist_launch 2 run")
        return {"wall_s": run["wall_s"], "cpu_s": run["cpu_s"],
                "processes": 2, "byte_identical": True}

    def workload(deep):
        d = tempfile.mkdtemp(prefix="probe_", dir=work)
        wl, nreads = make_workload(d, deep)
        return dict(run_pipeline(d, wl, "run"), reads=nreads)

    found = {}
    for name, fn in (
            ("policy", crossover.measure_policy),
            ("coverage_crossover", crossover.measure_coverage),
            ("mfu", lambda: mfu.measure_all(reps=3)),
            ("scaling_shape", lambda: scaling.measure_scaling_shape([1])),
            ("jax_dist", jax_dist),
            ("small", lambda: workload(False)),
            ("deep", lambda: workload(True))):
        t0 = time.perf_counter()
        try:
            found[name] = fn()
        except Exception as e:      # a probe's failure is reported, not fatal
            found[name] = {"error": "%s: %s" % (type(e).__name__, e)}
        log("probe %s: %.1f s%s" % (name, time.perf_counter() - t0,
                                     ", FAILED: " + found[name]["error"]
                                     if "error" in found[name] else ""))
    return found


# ---------------------------------------------------------------- emit
def _r(x):
    return round(x, 6) if isinstance(x, float) else x


def headline(res, device, setup, detail_file):
    """The compact headline of one cell's record."""
    on_card = device["platform"] == "gpu"
    stages = {k: {"launches": v["launches"], "dispatches": v["dispatches"],
                  "kernel_ms": _r(v["kernel_ms"])}
              for k, v in res["stages"].items()}
    return {
        "metric": "bundles_per_second", "value": _r(res["value"]),
        "unit": "bundles/s", "config": res["config"], "mode": res["mode"],
        "seed": res["seed"], "reduced": res["reduced"],
        "wall_s": _r(res["wall_s"]),
        "wall_s_runs": [_r(w) for w in res["wall_s_runs"]],
        "ref_wall_s": _r(res["ref_wall_s"]),
        "ref_wall_s_runs": [_r(w) for w in res["ref_wall_s_runs"]],
        "binary_wall_s": _r(res["binary_wall_s"]),
        "vs_baseline": _r(res["vs_baseline"])
        if res["vs_baseline"] is not None else 0.0,
        "correct": res["correct"],
        "idle_share": _r(res["trace"]["idle_share"]) if on_card else None,
        "setup_s": {"import_torch": _r(setup["import_torch_s"]),
                    "cuda_context": _r(setup["cuda_context_s"]),
                    "calibration": [_r(c) for c in res["calibration_s_runs"]]},
        "stages": stages,
        "device": device,
        "detail_file": detail_file}


def emit(cells, probes_found, device, setup, detail_path):
    """Write the detail file and print the compact headline as the last
    line of stdout: the cell of config 3 under mode all when a sweep holds
    it, else the first; correct only if every cell is.  Returns the exit
    code: 1 if a cell differs or failed or a probe failed."""
    detail = {"metric": "bundles_per_second", "device": device,
              "setup_s": setup, "cells": cells, "probes": probes_found}
    with open(detail_path, "w") as fh:
        json.dump(detail, fh, indent=1)
    log("detail -> %s" % detail_path)
    done = [c for c in cells if "error" not in c]
    main = next((c for c in done if (c["config"], c["mode"]) == (3, "all")),
                done[0] if done else None)
    errors = sum(1 for p in (probes_found or {}).values()
                 if isinstance(p, dict) and "error" in p)
    correct = len(done) == len(cells) and all(c["correct"] for c in cells)
    if main is None:
        head = {"metric": "bundles_per_second", "value": 0.0,
                "unit": "bundles/s", "vs_baseline": 0.0, "correct": False,
                "error": cells[0]["error"][:300] if cells else "no cell",
                "device": device, "detail_file": detail_path}
    else:
        head = headline(main, device, setup, detail_path)
        head["correct"] = correct
    if len(cells) > 1:
        head["cells"] = len(cells)
    head["probe_errors"] = errors
    print(json.dumps(head, separators=(",", ":")), flush=True)
    return 0 if correct and not errors else 1


# ---------------------------------------------------------------- main
def device_info():
    """{"platform", "kind", "count", "power_limit"} of the port's device.
    Raises RuntimeError when cuda is asked for and there is no card."""
    import torch

    from aletsch_tpu_torch.device import device
    from aletsch_tpu_torch.ops import mfu
    dev = device()
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "power_limit": None}
    return {"platform": "gpu", "kind": mfu.device_kind(dev),
            "count": torch.cuda.device_count(),
            "power_limit": mfu.power_limit()}


def parse_args(argv):
    opts = {"config": 3, "mode": "all", "reps": 3, "seed": None,
            "genes": None, "samples": None, "detail": None, "probes": False,
            "sweep": False}
    i = 0
    while i < len(argv):
        key = argv[i][2:] if argv[i].startswith("--") else None
        if key in ("probes", "sweep"):
            opts[key] = True
            i += 1
            continue
        if key not in opts or i + 1 >= len(argv):
            raise ValueError("unknown or incomplete argument %r" % argv[i])
        opts[key] = argv[i + 1] if key in ("mode", "detail") \
            else int(argv[i + 1])
        i += 2
    if opts["config"] not in CONFIGS or opts["mode"] not in MODES \
            or opts["reps"] < 1:
        raise ValueError("--config takes 3, 4 or 5, --mode one of %s, "
                         "--reps at least 1" % ", ".join(MODES))
    return opts


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = parse_args(argv)
    except ValueError as e:
        print("bench_torch: %s\n%s" % (e, __doc__.split("\n\n")[1]),
              file=sys.stderr)
        return 2
    smoke = _smoke()
    try:
        device = device_info()
    except RuntimeError as e:
        print("bench_torch: %s" % e, file=sys.stderr)
        return 1
    on_card = device["platform"] == "gpu"
    env = dict(os.environ, PYTHONPATH=REPO)
    # the traced runs keep the profiler's one CUPTI a process
    env.pop("TEARDOWN_CUPTI", None)
    detail_path = opts["detail"] or os.path.join(REPO, DETAIL)
    plan = SWEEP if opts["sweep"] else [(opts["config"], opts["mode"])]
    cells = []
    with tempfile.TemporaryDirectory(prefix="aletsch_bench_torch_") as work:
        build_s = prepare(work, on_card)
        setup = dict(setup_times(env, on_card), build_s=build_s)
        binary = upstream_binary(work)
        log("device %s; builds %.1f s; import torch %.2f s; the upstream "
            "binary %s" % (device, build_s, setup["import_torch_s"],
                           binary or "absent"))
        for config, mode in plan:
            genes = opts["genes"] or CONFIGS[config][1]
            samples = opts["samples"] or CONFIGS[config][2]
            seed = default_seed(config) if opts["seed"] is None \
                else opts["seed"]
            cdir = tempfile.mkdtemp(prefix="c%d_%s_" % (config, mode),
                                    dir=work)
            try:
                cells.append(cell(config, mode, opts["reps"], seed, genes,
                                  samples, cdir, env, on_card, binary))
            except (BenchFailure, smoke.SmokeFailure,
                    subprocess.SubprocessError) as e:
                log("config %d %s FAILED: %s" % (config, mode, e))
                cells.append({"config": config, "mode": mode,
                              "error": str(e), "correct": False})
            shutil.rmtree(cdir, ignore_errors=True)
        found = None
        if opts["probes"]:
            first = cells[0]
            lst, _ = cohort(first["config"], opts["genes"] or CONFIGS[
                first["config"]][1], opts["samples"] or CONFIGS[
                first["config"]][2], first.get("seed") or default_seed(
                first["config"]))
            ref_dir = os.path.join(work, "probe_reference")
            run_cli("aletsch_tpu", lst, "reference", ref_dir, env)
            found = probes(work, lst, ref_dir, env)
        return emit(cells, found, device, setup, detail_path)


if __name__ == "__main__":
    sys.exit(main())
