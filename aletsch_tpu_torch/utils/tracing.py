"""Phase tracing, counters, and memory probes (SURVEY §5).

The reference's observability is printf-based: wall-clock `ctime` lines at
phase boundaries (meta/incubator.cc:73-78), an RSS probe `check_memory_usage`
(meta/generator.cc:27-31), and per-group stats summaries gated on `verbose`
(meta/bundle_group.cc:360-393).  This module re-expresses that as a Tracer
with nested phase timers and counters.  Counterpart of
aletsch_tpu/utils/tracing.py without its jax.profiler capture: the hooks
stay so the incubator reads the same, and --jax_profile_dir is refused until
the torch.profiler capture is ported.

Verbose levels follow the reference convention (util/parameters.cc:28):
  0 silent, 1 phase lines + final summary, 2 per-region lines,
  3 per-group stats.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager


TRACE_UNPORTED = ("--jax_profile_dir: device tracing is not ported to "
                  "aletsch_tpu_torch yet (ROADMAP Queue 1 item 11)")


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


class Tracer:
    def __init__(self, verbose=0, stream=None, jax_profile_dir=""):
        self.verbose = verbose
        self.stream = stream if stream is not None else sys.stderr
        self.counters = {}
        self.phase_times = {}
        self.t0 = time.perf_counter()
        self._jax_dir = jax_profile_dir

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
        """The JAX package captures a jax.profiler trace here.  The port has
        no device trace yet, so a run that asks for one is refused."""
        if self._jax_dir:
            raise NotImplementedError(TRACE_UNPORTED)

    def stop_jax_trace(self):
        """Nothing to stop: start_jax_trace never starts a capture."""


class NullTracer(Tracer):
    """verbose=0 tracer with no stream setup cost."""

    def __init__(self):
        super().__init__(verbose=0)
