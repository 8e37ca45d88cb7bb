"""One run of one cell: set-up, the window, the reference, the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (setup_s, from the process's start to the window's): import torch
and the port, make the CUDA context, load the kernel library and the C++
core (built into build/ of the checkout on its first run); build the
cell's cohort from --seed with the frozen generator (cohortgen/) under
the temporary directory, and its warm-up cut (the same samples' first
genes); read the BAMs once; run one warm-up pass on the cut with the
cell's flags.  Then the window: whole passes back to back for --seconds
(window.run_window), under one profiler capture with --trace 1.  Then,
outside every clock: the device's memory peak, the trace's reduction,
the program's state freed, the reference run and the comparison
(judge.py), and the metrics, each read by its own file under metrics/.

The last line of stdout is one JSON object: correct, attempted (passes),
failed (passes that raised or differ), metrics (the cell's end-to-end
metrics with --trace 0, its per-layer ones with --trace 1), device, with
--trace 1 a breakdown, and last the numbers compared with their limits
(checks), which are also the last lines of stderr.  Exit 1 without a
result where the card is missing or has fewer devices than the cell
asks, where the program is not in the checkout, where a traced run's
capture holds another number of device records than calls queued them,
where a control (--control) never acted in the window, or where jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import resource
import shutil
import subprocess
import sys
import tempfile
import time

from . import judge as judge_mod
from . import spec
from .window import PROGRAM, DrainSample, Hooks, Port, install_spans, \
    run_pass, run_window

# whole top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "aletsch_tpu")
# build and kernel caches of the program and of PyTorch's extensions, at
# fixed paths inside the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": ("build", "bench_cache",
                                      "torch_extensions"),
             "TRITON_CACHE_DIR": ("build", "bench_cache", "triton")}
COHORT_JOBS = 8


def log(msg):
    print("[bench] %s" % msg, file=sys.stderr, flush=True)


def seconds_since_start():
    """Seconds from this process's start (the kernel's record of it) to
    now; 0.0 where /proc does not say."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - seconds_since_start()


class Run:
    """What a metric's reader reads: the cell, the passes of the window
    and its seconds, the set-up's parts, the trace's reduction (None
    without --trace 1 or off the card), what the hooks logged, and the
    device's memory peak."""

    def __init__(self, cell):
        self.cell = cell
        self.passes = []
        self.window_s = 0.0
        self.setup = {}
        self.trace = None
        self.logs = {}
        self.memory_peak_bytes = 0


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="a control of controls/ (checks of the comparison "
                    "only, never a timed run of the benchmark's own)")
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({name.split(".")[0] for name, mod in
                   list(sys.modules.items()) if mod is not None}
                  & set(FORBIDDEN))


def build_cohort(cfg, base, seed, cut=None, genes=None):
    """(bams.list, records) of the configuration's cohort under base;
    cut overrides builder arguments (tests), genes the gene count (the
    warm-up cut)."""
    from cohortgen import cohorts
    c = cfg["cohort"]
    args = dict(c["args"], **(cut or {}))
    if genes is not None:
        args["n_genes"] = min(genes, args["n_genes"])
    return cohorts.BUILDERS[c["builder"]](
        base, seed=seed, jobs=min(COHORT_JOBS, os.cpu_count() or 1), **args)


def read_all(lst):
    """Read every BAM of lst once (the page cache)."""
    with open(lst) as fh:
        for line in fh:
            if line.strip():
                with open(line.split()[0], "rb") as bam:
                    while bam.read(1 << 22):
                        pass


def cpu_s():
    """This process's CPU seconds, read beside the window: how much of the
    window's wall its threads ran."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def card_info(on_card, chips):
    if not on_card:
        return {"platform": "cpu", "kind": platform.processor() or "cpu",
                "count": 1}
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        out["nvidia_smi"] = res.stdout.strip().splitlines()[:chips]
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    return out


def main(argv, on_cpu=False, cut=None):
    """The run; returns the exit code.  on_cpu (tests only) runs the
    port's plain versions on the CPU instead of asking for the card; cut
    overrides the cohort builder's sizes (tests only)."""
    args = parse_args(argv)
    bench = spec.load_bench()
    cell = spec.Cell(bench, args.workload, bool(args.trace))
    chips = int(cell.spec["chips"])
    if not os.path.isdir(os.path.join(spec.ROOT, PROGRAM)):
        log("the program (%s/) is not in the checkout %s"
            % (PROGRAM, spec.ROOT))
        return 1
    for var, parts in CACHE_ENV.items():
        os.environ[var] = os.path.join(spec.ROOT, *parts)
    os.environ["USE_FLAX"] = "0"
    os.environ["ALETSCH_TORCH_DEVICE"] = "cpu" if on_cpu else "cuda"
    if spec.ROOT not in sys.path:
        sys.path.insert(1, spec.ROOT)
    t = time.perf_counter()
    import torch
    on_card = not on_cpu
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < chips):
        log("the cell %s needs %d CUDA device(s): torch.cuda.is_available() "
            "is %s, device_count() %d" % (cell.name, chips,
                                           torch.cuda.is_available(),
                                           torch.cuda.device_count()))
        return 1
    run = Run(cell)
    port = Port(on_card)
    run.setup["import_s"] = time.perf_counter() - t
    control = None
    if args.control:
        control = spec.load_control(args.control)
    work = tempfile.mkdtemp(prefix="aletsch_bench_")
    try:
        return _measure(args, cell, run, port, control, work, on_card,
                        chips, cut)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _measure(args, cell, run, port, control, work, on_card, chips, cut):
    cfg, mix = cell.config, cell.mix
    flags = list(cfg["flags"]) + list(mix["flags"])
    t = time.perf_counter()
    lst, records = build_cohort(cfg, os.path.join(work, "cohort"),
                                args.seed, cut)
    wlst, _ = build_cohort(cfg, os.path.join(work, "warmup_cohort"),
                           args.seed, cut, genes=cfg["cohort"]["warmup_genes"])
    read_all(lst)
    run.setup["cohort_s"] = time.perf_counter() - t
    os.environ.update(mix.get("env", {}))
    if control is not None:
        control.install()
    t = time.perf_counter()
    warm = run_pass(port, wlst, os.path.join(work, "warmup"), flags)
    if warm.error is not None:
        log("the warm-up pass failed:\n%s" % warm.error)
    log("warm-up: %.3f s, %d bundles, %s" % (
        warm.seconds, warm.bundles, {k: warm.stats.get(k) for k in
                                     mix.get("engaged", [])}))
    run.setup["warmup_s"] = time.perf_counter() - t
    hooks = capture = None
    if args.trace:
        from .trace import Capture
        hooks = Hooks()
        install_spans(port, hooks)
        for reader in cell.readers.values():
            if hasattr(reader, "install"):
                reader.install(hooks)
        capture = Capture(on_card)
        capture.start()
    sample_hooks = Hooks()
    sample = DrainSample(args.seed)
    sample.install(sample_hooks)
    lowered = control.calls() if control is not None else 0
    cpu0 = cpu_s()
    t_window = time.perf_counter()
    run.setup["setup_s"] = t_window - T_START
    run.passes, run.window_s = run_window(port, lst, os.path.join(
        work, "passes"), flags, args.seconds)
    log("window: %.3f s wall, %.3f s of this process's CPU"
        % (run.window_s, cpu_s() - cpu0))
    sample_hooks.remove()
    if on_card:
        run.memory_peak_bytes = int(torch_max_memory())
    else:
        run.memory_peak_bytes = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024
    refuse = None
    if capture is not None:
        run.trace = capture.stop(os.path.join(work, "trace.json"))
        log("trace: %d bytes, %d events, device records %s"
            % (run.trace.size_bytes, run.trace.n_events, run.trace.counts))
        if run.trace.dropped():
            refuse = ("the capture holds %d device records for %d calls "
                      "that queued one each"
                      % (run.trace.records(), run.trace.counts["enqueued"]))
        run.logs = hooks.logs
        hooks.remove()
    if control is not None:
        lowered = control.calls() - lowered
        log("control %s: %d calls lowered in the window"
            % (args.control, lowered))
        if not lowered:
            refuse = "the control %s never acted in the window" % args.control
        control.remove()
    port.free()
    if refuse is not None:
        log("%s; no result" % refuse)
        return 1
    log("cohort %d records; setup %.3f s (import %.3f, cohort %.3f, "
        "warm-up %.3f); %d passes in %.3f s: %s"
        % (records, run.setup["setup_s"], run.setup["import_s"],
           run.setup["cohort_s"], run.setup["warmup_s"], len(run.passes),
           run.window_s, ", ".join("%.3f s %d bundles" % (p.seconds,
                                                         p.bundles)
                                   for p in run.passes)))
    for i, p in enumerate(run.passes):
        if p.error is not None:
            log("a pass failed:\n%s" % p.error)
        log("pass %d: %.3f s; phases %s; solve() %s" % (
            i, p.seconds, {k: round(v, 3) for k, v in p.phases.items()},
            {k: round(v, 3) for k, v in p.stats.items()
             if k.endswith("device_time")}))
    ref_dir = os.path.join(work, "reference")
    ref_flags = list(cfg["flags"]) + ["--device_greedy", "off", "--verbose",
                                      "0"]
    try:
        ref = judge_mod.run_reference(lst, ref_dir, ref_flags)
        checks, bad, compared = judge_mod.judge(run.passes, ref, ref_dir,
                                                mix, sample.batches)
        log("reference: %d bundles in %.3f s; %d sampled drain rows "
            "compared" % (ref["bundles"], ref["seconds"], compared))
    except (RuntimeError, OSError, ValueError,
            subprocess.SubprocessError) as e:
        log("the reference failed: %s" % e)
        checks = dict.fromkeys(judge_mod.LIMITS, None)
        bad = len(run.passes)
    correct = bool(run.passes) and all(
        v is not None and v <= judge_mod.LIMITS[k] for k, v in checks.items())
    metrics = {}
    for name, entry in cell.metrics.items():
        value = cell.readers[name].read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": entry["unit"]}
    device = card_info(on_card, chips)
    device["memory_peak_bytes"] = run.memory_peak_bytes
    result = {"correct": correct, "attempted": len(run.passes),
              "failed": bad, "metrics": metrics, "device": device}
    if run.trace is not None:
        busy = run.trace.busy_us() / 1e6
        device["busy_s"] = busy
        device["window_s"] = run.trace.window_us / 1e6
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": judge_mod.LIMITS[k]}
                        for k, v in checks.items()}
    found = forbidden_modules()
    if found:
        log("loaded in this process: %s; no result" % ", ".join(found))
        return 1
    print(json.dumps(result), flush=True)
    for k, v in checks.items():
        print("check %s %s limit %s" % (k, v, judge_mod.LIMITS[k]),
              file=sys.stderr, flush=True)
    return 0


def torch_max_memory():
    import torch
    return torch.cuda.max_memory_allocated()
