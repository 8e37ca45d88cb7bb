"""Phase tracing, counters, and memory probes (SURVEY §5).

The reference's observability is printf-based: wall-clock `ctime` lines at
phase boundaries (meta/incubator.cc:73-78), an RSS probe `check_memory_usage`
(meta/generator.cc:27-31), and per-group stats summaries gated on `verbose`
(meta/bundle_group.cc:360-393).  This module re-expresses that as a Tracer
with nested phase timers and counters, plus an optional device trace.
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
import re
import sys
import time
from contextlib import contextmanager

# a trace's categories of device work (torch.profiler's chrome trace), and
# the runtime and driver calls that queue one record of it each
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ENQUEUE = re.compile(r"^cu(da)?(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")


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

    # ----------------------------------------------------------------- phases
    @contextmanager
    def phase(self, name):
        t = time.perf_counter()
        c = time.process_time()
        if self.verbose >= 1:
            print("[aletsch] %s ..." % name, file=self.stream)
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            dc = time.process_time() - c
            self.phase_times[name] = self.phase_times.get(name, 0.0) + dt
            if self.verbose >= 1:
                print("[aletsch] %s done in %.2fs (cpu %.2fs = %.2f cores, "
                      "rss %.0f MB)"
                      % (name, dt, dc, dc / dt if dt > 0 else 0.0,
                         rss_mb()), file=self.stream)

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
        for name, dt in sorted(self.phase_times.items(),
                               key=lambda kv: -kv[1]):
            print("[aletsch]   %-12s %6.2fs" % (name, dt), file=self.stream)
        bundles = self.counters.get("bundles", 0)
        if bundles and total > 0:
            print("[aletsch] %d bundles -> %.1f bundles/s" %
                  (bundles, bundles / total), file=self.stream)

    # ------------------------------------------------- device profiler hooks
    def start_jax_trace(self):
        """Optional device trace: a torch.profiler capture of the host's
        activity, and of the card's where the port's device is a card,
        written on stop by tensorboard_trace_handler into the directory
        as <host>_<pid>.<ns>.pt.trace.json.  No shapes and no stacks, to
        keep the file small.  On the CPU device no CUDA context is made.
        On a card the trace holds a device record of every kernel and copy
        queued in the capture (device_counts), as the one capture of a
        CLI process: a process that captures again after tens of seconds
        of other work gets some of its device records placed outside the
        capture's window by the profiler, which drops them (PERF.md).
        torch is imported here only.  A failure propagates."""
        if not self._jax_dir:
            return
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                    profile, tensorboard_trace_handler)

        from ..device import device as port_device
        activities = [ProfilerActivity.CPU]
        if port_device().type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        # the region waves run on pool threads: record every thread's ops
        prof = profile(activities=activities, on_trace_ready=
                       tensorboard_trace_handler(self._jax_dir),
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.start()
        self._jax_active = prof

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
