"""Phase tracing, counters, and memory probes (SURVEY §5).

The reference's observability is printf-based: wall-clock `ctime` lines at
phase boundaries (meta/incubator.cc:73-78), an RSS probe `check_memory_usage`
(meta/generator.cc:27-31), and per-group stats summaries gated on `verbose`
(meta/bundle_group.cc:360-393).  This module re-expresses that as a Tracer
with nested phase timers and counters, plus an optional device trace.
Spans (Tracer.span) time the layers inside a phase, on whichever thread
runs them: their seconds go into the same phase_times, and while a
torch.profiler capture is active each is also a record_function range, on
the trace's clock beside the card's records.
Counterpart of aletsch_tpu/utils/tracing.py: where the JAX package captures
a jax.profiler trace, the port captures a torch.profiler one into the same
--jax_profile_dir (the flag keeps its name; the *.pt.trace.json file opens
in TensorBoard and in Perfetto).

Verbose levels follow the reference convention (util/parameters.cc:28):
  0 silent, 1 phase lines + final summary, 2 per-region lines,
  3 per-group stats.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from contextlib import contextmanager

# a trace's categories of device work (torch.profiler's chrome trace), and
# the runtime and driver calls that queue one record of it each
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ENQUEUE = re.compile(r"^cu(da)?(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")


def _profiler():
    """torch's profiler module while a torch.profiler capture is active in
    this process (the profiler's own flag, on every thread), else None;
    nothing imports torch to answer it."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


def rss_mb():
    """Resident set size in MB (check_memory_usage, meta/generator.cc:27-31)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def read_trace(path):
    """The event list of a *.pt.trace.json file."""
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def add_regions(events, entered):
    """Write into the args of each span's range the region it ran for
    (args["region"], "chrm:rid").  entered is [(thread id, span name,
    region)] in the order the spans were entered; a thread's ranges of
    one name are matched to its entries of that name in order of start.
    Where the two counts differ (a range the profiler dropped), that
    thread's ranges of that name are left as they are."""
    want = {}
    for tid, name, region in entered:
        want.setdefault((tid, name), []).append(region)
    got = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            key = (e.get("tid"), e.get("name"))
            if key in want:
                got.setdefault(key, []).append(e)
    for key, ranges in got.items():
        regions = want[key]
        if len(ranges) != len(regions):
            continue
        ranges.sort(key=lambda e: float(e["ts"]))
        for e, region in zip(ranges, regions):
            if region is not None:
                e.setdefault("args", {})["region"] = region


def device_counts(events):
    """What a trace's events hold of the card's work: {category: count}
    of its device records (DEVICE_CATS), and under "enqueued" the host's
    calls that queued one each (kernel launches, copies, memsets, by the
    runtime or the driver).  A trace that records every kernel and copy
    holds as many device records as enqueueing calls."""
    out = dict.fromkeys(DEVICE_CATS, 0)
    out["enqueued"] = 0
    for e in events:
        cat = e.get("cat")
        if cat in out:
            out[cat] += 1
        elif cat in ("cuda_runtime", "cuda_driver") \
                and _ENQUEUE.match(e.get("name", "")):
            out["enqueued"] += 1
    return out


class Tracer:
    def __init__(self, verbose=0, stream=None, jax_profile_dir=""):
        self.verbose = verbose
        self.stream = stream if stream is not None else sys.stderr
        self.counters = {}
        self.phase_times = {}
        self.t0 = time.perf_counter()
        self._jax_dir = jax_profile_dir
        self._jax_active = False
        # span name -> the span or phase it first opened inside (summary)
        self.span_parent = {}
        self._open = []             # the phases open, outermost first
        self._local = threading.local()     # a thread's open spans
        # (thread id, span, region) of each span entered under the port's
        # own capture, for the regions in its trace (add_regions)
        self._entered = []

    # ----------------------------------------------------------------- phases
    @contextmanager
    def phase(self, name):
        t = time.perf_counter()
        c = time.process_time()
        if self.verbose >= 1:
            print("[aletsch] %s ..." % name, file=self.stream)
        prof = _profiler()
        rf = prof.record_function(name).__enter__() if prof else None
        self._open.append(name)
        try:
            yield
        finally:
            self._open.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            dt = time.perf_counter() - t
            dc = time.process_time() - c
            self.phase_times[name] = self.phase_times.get(name, 0.0) + dt
            if self.verbose >= 1:
                print("[aletsch] %s done in %.2fs (cpu %.2fs = %.2f cores, "
                      "rss %.0f MB)"
                      % (name, dt, dc, dc / dt if dt > 0 else 0.0,
                         rss_mb()), file=self.stream)

    # ------------------------------------------------------------------ spans
    def _stack(self):
        """This thread's open spans and regions: [(name, region)]."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _nest(self, name, stack):
        """Note what the span `name` first opened inside: the innermost
        span open on this thread, else the innermost phase open."""
        if name not in self.span_parent:
            parent = next((n for n, _ in reversed(stack) if n is not None),
                          None)
            if parent is None:      # a slice: phases close on other threads
                parent = (self._open[-1:] or [None])[0]
            self.span_parent[name] = parent

    @contextmanager
    def span(self, name, region=None, tile=False):
        """Time a layer inside a phase: its wall seconds are added to
        phase_times[name].  While a torch.profiler capture is active it is
        also a record_function range; region ("chrm:rid"; None: the
        region of the span or region() it is opened in) joins the ranges
        one region leaves on the pipeline's threads, and lands in the
        range's args in the port's own trace.  tile: the clock starts
        where the span this thread closed last ended, so that spans opened
        one after another with it leave no time of the thread out (the
        interpreter lock and the collector take the thread between any
        two statements); the range still starts here.  Never through
        phase(), which a caller may wrap."""
        stack = self._stack()
        self._nest(name, stack)
        if region is None and stack:
            region = stack[-1][1]
        stack.append((name, region))
        # the clock holds the range's own entry and exit: a thread can wait
        # there for the interpreter lock, and that time is the span's
        t = time.perf_counter()
        if tile:
            t = getattr(self._local, "closed", t)
        prof = _profiler()
        rf = None
        if prof is not None:
            if self._jax_active:
                self._entered.append((threading.get_native_id(), name,
                                      region))
            rf = prof.record_function(name).__enter__()
        try:
            yield
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
            stack.pop()
            self._local.closed = end = time.perf_counter()
            self.phase_times[name] = self.phase_times.get(name, 0.0) \
                + end - t

    def tile_from(self, t):
        """The next span this thread opens with tile starts its clock at t,
        a time.perf_counter() reading, as if a span had closed then."""
        self._local.closed = t

    @contextmanager
    def region(self, region):
        """The spans this thread opens inside carry `region`; no span of
        its own."""
        stack = self._stack()
        stack.append((None, region))
        try:
            yield
        finally:
            stack.pop()

    def add_time(self, name, seconds, parent=None):
        """Add seconds to a span that is a clock only (summed by its
        caller, never a range), nested in the span open on this thread, or
        in `parent` (a clock it is a part of)."""
        if parent is None:
            self._nest(name, self._stack())
        else:
            self.span_parent.setdefault(name, parent)
        self.phase_times[name] = self.phase_times.get(name, 0.0) + seconds

    # --------------------------------------------------------------- counters
    def add(self, key, n=1):
        self.counters[key] = self.counters.get(key, 0) + n

    def region_line(self, chrm, rid, nbundles, ngroups):
        if self.verbose >= 2:
            print("[aletsch] region %s:%d  bundles=%d groups=%d rss=%.0fMB"
                  % (chrm, rid, nbundles, ngroups, rss_mb()),
                  file=self.stream)

    def group_line(self, chrm, strand, rid, ngraphs, nclusters):
        if self.verbose >= 3:
            print("[aletsch] group %s%s:%d  graphs=%d clusters=%d"
                  % (chrm, strand, rid, ngraphs, nclusters),
                  file=self.stream)

    # ---------------------------------------------------------------- summary
    def summary(self):
        if self.verbose < 1:
            return
        total = time.perf_counter() - self.t0
        print("[aletsch] total %.2fs, peak-phase breakdown:" % total,
              file=self.stream)
        inside = {}
        for name, parent in self.span_parent.items():
            inside.setdefault(parent, []).append(name)

        def show(names, depth):
            for name in sorted(names, key=lambda n: -self.phase_times[n]):
                print("[aletsch]   %-*s %6.2fs" % (
                    12 + 2 * depth, "  " * depth + name,
                    self.phase_times[name]), file=self.stream)
                show(inside.get(name, ()), depth + 1)

        show([n for n in self.phase_times
              if self.span_parent.get(n) is None], 0)
        bundles = self.counters.get("bundles", 0)
        if bundles and total > 0:
            print("[aletsch] %d bundles -> %.1f bundles/s" %
                  (bundles, bundles / total), file=self.stream)

    # ------------------------------------------------- device profiler hooks
    def start_jax_trace(self):
        """Optional device trace: a torch.profiler capture of the host's
        activity, and of the card's where the port's device is a card,
        written on stop into the directory as
        <host>_<pid>.<ns>.pt.trace.json (_write_trace).  No shapes and no
        stacks, to keep the file small.  On the CPU device no CUDA context
        is made.  On a card the trace holds a device record of every kernel
        and copy queued in the capture (device_counts), as the one capture
        of a CLI process: a process that captures again after tens of seconds
        of other work gets some of its device records placed outside the
        capture's window by the profiler, which drops them (PERF.md).
        torch is imported here only.  A failure propagates."""
        if not self._jax_dir:
            return
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                    profile)

        from ..device import device as port_device
        activities = [ProfilerActivity.CPU]
        if port_device().type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # the region waves run on pool threads: record every thread's ops
        prof = profile(activities=activities, on_trace_ready=
                       self._write_trace,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.start()
        self._jax_active = prof

    def _write_trace(self, prof):
        """The capture's trace file, named as tensorboard_trace_handler
        names it, with the region of each span in its range's args
        (add_regions)."""
        import socket
        os.makedirs(self._jax_dir, exist_ok=True)
        path = os.path.join(self._jax_dir, "%s_%d.%d.pt.trace.json" % (
            socket.gethostname(), os.getpid(), time.time_ns()))
        prof.export_chrome_trace(path)
        entered, self._entered = self._entered, []
        if entered:
            with open(path) as fh:
                trace = json.load(fh)
            add_regions(trace["traceEvents"], entered)
            with open(path, "w") as fh:
                json.dump(trace, fh)

    def stop_jax_trace(self):
        """Stop the capture start_jax_trace began (self._jax_active holds
        its profiler) and write the trace file.  On a card, the card
        finishes its queued work first, so that every kernel and copy
        launched inside the capture has its device record when the
        profiler collects them."""
        if not self._jax_active:
            return
        prof, self._jax_active = self._jax_active, False
        from torch.profiler import ProfilerActivity
        if ProfilerActivity.CUDA in prof.activities:
            import torch

            from ..device import device as port_device
            torch.cuda.synchronize(port_device())
        prof.stop()


class NullTracer(Tracer):
    """verbose=0 tracer with no stream setup cost."""

    def __init__(self):
        super().__init__(verbose=0)
