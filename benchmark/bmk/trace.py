"""The traced run's one capture, and what is read from it.

A traced run wraps its whole window in one torch.profiler capture of the
host's and the card's activity on every thread (the region waves launch
from pool threads), writes it as a chrome trace under the run's temporary
directory, reduces it and deletes the file.  The arithmetic is a copy of
the port's (aletsch_tpu_torch/utils/tracing.py::device_counts,
bench_torch.py::device_busy_us, capture_window_us, idle_share,
kernel_times), sound since the port's trace was repaired to record every
kernel and copy of one capture a process.
"""

from __future__ import annotations

import json
import os
import re

# a trace's categories of device work, and the runtime and driver calls
# that queue one record of it each
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_ENQUEUE = re.compile(r"^cu(da)?(Launch\w*Kernel\w*|Memcpy\w*|Memset\w*)$")
# host records that can name what the host did in an idle gap: the
# harness's own spans (record_function) first, then the framework's ops
SPAN_CATS = ("user_annotation", "cpu_op", "python_function")
TOP = 10


class Capture:
    """One torch.profiler capture of CPU and, on a card, CUDA activity on
    every thread."""

    def __init__(self, on_card):
        from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                    profile)
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        self.on_card = on_card
        self.prof = profile(activities=acts,
                            experimental_config=_ExperimentalConfig(
                                profile_all_threads=True))

    def start(self):
        self.prof.start()

    def stop(self, path):
        """Stop (the card finishes its queued work first, so that every
        kernel launched in the window has its record), write the trace to
        path, and return its reduction (Reduced); the file is deleted."""
        import torch
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
            size = os.path.getsize(path)
        finally:
            os.remove(path)
        return Reduced(events, size)


def device_counts(events):
    """{category: count} of the device records, and under "enqueued" the
    host's calls that queued one each."""
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


def busy_intervals(device):
    """The union of the device records' [start, end) intervals (us),
    merged and in order."""
    out = []
    for a, b in sorted((ts, ts + dur) for _, ts, dur in device):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_busy_us(device):
    """The time (us) in which the card held at least one device record:
    overlapping records count once."""
    return sum(b - a for a, b in busy_intervals(device))


def kernel_times(device):
    """{record name: [count, us]} of the device records."""
    by = {}
    for name, _, dur in device:
        c, us = by.get(name, (0, 0.0))
        by[name] = [c + 1, us + dur]
    return by


class Reduced:
    """What the run keeps of a trace: the device records (name, ts, dur
    in us), the capture's span, the host spans that name idle gaps, the
    record counts and the file's size."""

    def __init__(self, events, size_bytes):
        self.size_bytes = size_bytes
        self.n_events = len(events)
        self.counts = device_counts(events)
        self.device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                       for e in events if e.get("cat") in DEVICE_CATS]
        spans = [e for e in events if e.get("cat") == "Trace"]
        if len(spans) == 1:
            self.t0 = float(spans[0]["ts"])
            self.window_us = float(spans[0]["dur"])
        else:       # no capture span: the extent of every record
            ts = [float(e["ts"]) for e in events if "ts" in e]
            te = [float(e["ts"]) + float(e.get("dur", 0.0))
                  for e in events if "ts" in e]
            self.t0 = min(ts) if ts else 0.0
            self.window_us = (max(te) - self.t0) if te else 0.0
        self.host = [(e["cat"], e["name"], float(e["ts"]),
                      float(e.get("dur", 0.0)))
                     for e in events if e.get("cat") in SPAN_CATS
                     and e.get("ph") == "X"]

    def records(self):
        """The device records the capture holds."""
        return sum(self.counts[c] for c in DEVICE_CATS)

    def dropped(self):
        """Whether the device records differ in number from the host's
        calls that queued one each: a capture that lost records (or
        holds records no call queued) is not read."""
        return self.records() != self.counts["enqueued"]

    def busy_us(self):
        return device_busy_us(self.device)

    def idle_share(self):
        """1 - the card's busy time over the capture; None without a
        device record (nothing ran on a card)."""
        if not self.device or self.window_us <= 0:
            return None
        return 1.0 - self.busy_us() / self.window_us

    def kernel_us(self, fragment):
        """(launches, summed device us) of the kernels whose name holds
        fragment."""
        n, us = 0, 0.0
        for name, c_us in kernel_times(self.device).items():
            if fragment in name:
                n += c_us[0]
                us += c_us[1]
        return n, us

    def top_ops(self):
        """The device operations that took most time: [[name, s], ...]."""
        by = kernel_times(self.device)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:TOP]
        return [[name, v[1] / 1e6] for name, v in top]

    def idle_gaps(self):
        """The longest idle gaps of the card inside the capture, each
        named by the innermost host span that covers the gap's middle
        (the harness's spans before the framework's ops): [[name, s],
        ...]."""
        end = self.t0 + self.window_us
        gaps, cur = [], self.t0
        for a, b in busy_intervals(self.device):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if end > cur:
            gaps.append((cur, end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:TOP]:
            mid = (a + b) / 2
            best = None
            for c, name, ts, dur in self.host:
                if ts <= mid <= ts + dur:
                    key = (SPAN_CATS.index(c), dur)
                    if best is None or key < best[0]:
                        best = (key, name)
            out.append([best[1] if best else "no host span", (b - a) / 1e6])
        return out
