"""Set-up, the warm-up and the timed passes of one run, and the spans and
hooks of a traced run.

A pass is what the port's CLI runs for the cell's flags
(aletsch_tpu_torch/__main__.py::main): Incubator(parse_all(argv))
.resolve() in this process, over the whole cohort, writing the meta GTF,
the per-sample GTFs and the feature CSVs into a directory of its own.
The window is a closed loop of whole passes, back to back, the way a user
runs one cohort after another.
"""

from __future__ import annotations

import os
import time
import traceback
from contextlib import contextmanager

PROGRAM = "aletsch_tpu_torch"


class Port:
    """The program under test: the modules a pass drives, imported from
    the checkout's root, with its CUDA context made and its kernel library
    and C++ core loaded (both built on a checkout's first run, into
    build/aletsch_tpu_torch/ of the checkout, and read from there later)."""

    def __init__(self, on_card):
        import torch

        from aletsch_tpu_torch.config import parse_all
        from aletsch_tpu_torch.meta import device_wave
        from aletsch_tpu_torch.meta.incubator import Incubator
        from aletsch_tpu_torch.utils import tracing
        self.torch = torch
        self.on_card = on_card
        self.parse_all = parse_all
        self.Incubator = Incubator
        self.device_wave = device_wave
        self.Tracer = tracing.Tracer
        if on_card:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            from aletsch_tpu_torch.ops import _build
            _build.load_library()
        device_wave.require_native()

    def sync(self):
        if self.on_card:
            self.torch.cuda.synchronize()

    def stats(self):
        return self.device_wave.device_stats()

    def free(self):
        """Drop the solvers and their buffers (the next wave would build
        them anew) and hand the card's cached memory back."""
        import gc
        self.device_wave.reset_solvers()
        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()


def stats_delta(before, after):
    """after - before of every number of device_stats() (counters and
    clocks are cumulative for the process); other values as after has
    them."""
    out = {}
    for k, v in after.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = v - before.get(k, 0)
        else:
            out[k] = v
    return out


class Pass:
    """One pass: its output directory, wall seconds, bundles, the
    Incubator's phase seconds (Tracer.phase_times), the device stats'
    change over it, and the error it raised (None)."""

    def __init__(self, out):
        self.out = out
        self.seconds = 0.0
        self.bundles = 0
        self.phases = {}
        self.stats = {}
        self.error = None


def run_pass(port, lst, out, flags):
    """One pass over the cohort of lst, its outputs under out."""
    p = Pass(out)
    os.makedirs(os.path.join(out, "gtf"))
    argv = ["-i", lst, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), *flags]
    before = port.stats()
    inc = None
    t0 = time.perf_counter()
    try:
        inc = port.Incubator(port.parse_all(argv))
        inc.resolve()
    except Exception:       # a pass that fails is judged, not fatal
        p.error = traceback.format_exc()
    finally:
        if inc is not None and inc._pool is not None:
            inc._pool.shutdown(wait=True)
        port.sync()
    p.seconds = time.perf_counter() - t0
    if inc is not None:
        p.bundles = inc.stats["bundles"]
        p.phases = dict(inc.tracer.phase_times)
    p.stats = stats_delta(before, port.stats())
    return p


def run_window(port, lst, work, flags, seconds):
    """Whole passes back to back until the first that ends at or after
    `seconds`, or the first that fails; (passes, window seconds)."""
    passes = []
    t0 = time.perf_counter()
    while True:
        p = run_pass(port, lst, os.path.join(work, "pass%d" % len(passes)),
                     flags)
        passes.append(p)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds or p.error is not None:
            return passes, elapsed


class Hooks:
    """Wrappers a traced run puts around the program's calls: each adds
    a span (torch.profiler.record_function) and may log what a call saw
    into logs[name].  remove() puts every call back."""

    def __init__(self):
        self.logs = {}
        self._undo = []

    def wrap(self, owner, attr, span=None, before=None, after=None,
             log=None):
        """Wrap owner.attr.  before(*args) runs before the call and its
        result goes to after(args, snapshot, result), whose result is
        appended to logs[log]."""
        from torch.profiler import record_function
        orig = getattr(owner, attr)
        entries = self.logs.setdefault(log, []) if log else None

        def wrapper(*args, **kw):
            snap = before(*args) if before else None
            if span:
                with record_function(span):
                    out = orig(*args, **kw)
            else:
                out = orig(*args, **kw)
            if after:
                entries.append(after(args, snap, out))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def remove(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


# the harness's spans around the calls into each layer: the Incubator's
# phases, a region wave on the card, and each solver's dispatch
SOLVERS = (("aletsch_tpu_torch.ops.greedy_fused", "DeviceGreedyFused",
            "solve.drain"),
           ("aletsch_tpu_torch.ops.bridge_topk", "DeviceBridge",
            "solve.bridge"),
           ("aletsch_tpu_torch.ops.support", "DeviceSupport",
            "solve.support"),
           ("aletsch_tpu_torch.ops.ladder_device", "DeviceLadder",
            "solve.ladder"))


def install_spans(port, hooks):
    import importlib

    from torch.profiler import record_function
    phase = port.Tracer.phase

    @contextmanager
    def spanned_phase(self, name):
        with record_function(name):
            with phase(self, name):
                yield

    port.Tracer.phase = spanned_phase
    hooks._undo.append((port.Tracer, "phase", phase))
    hooks.wrap(port.device_wave, "assemble_groups", span="wave")
    for module, cls, span in SOLVERS:
        hooks.wrap(getattr(importlib.import_module(module), cls), "solve",
                   span=span)


class DrainSample:
    """A sample, drawn from the seed, of the drain's dispatches in the
    window: each sampled dispatch's staged input rows and what solve()
    returned for them, for the reference to recompute once the window has
    closed (judge.drain_rows_differing).  The first FLOOR rows are taken,
    then each dispatch with probability RATE, up to CAP rows; the draw is
    the same for the same seed, as the dispatches are."""

    RATE = 1 / 16
    FLOOR = 64
    CAP = 512

    def __init__(self, seed):
        import random
        self.rng = random.Random(seed)
        self.rows = 0
        self.batches = []    # (W, P, sink, scal, maxp, paths, ws, npaths)

    def install(self, hooks):
        import numpy as np

        from aletsch_tpu_torch.ops.greedy_fused import DeviceGreedyFused

        def before(solver, nrows):
            draw = self.rng.random()
            if nrows == 0 or self.rows >= self.CAP \
                    or (self.rows >= self.FLOOR and draw >= self.RATE):
                return None
            n = min(nrows, self.CAP - self.rows)
            self.rows += n
            return n, (solver.W[:n].copy(), solver.P[:n].copy(),
                       solver.sink[:n].copy(), solver.scal[:n].copy(),
                       solver.maxp)

        def after(args, snap, out):
            if snap is None:
                return None
            n, staged = snap
            paths, ws, npaths = out
            self.batches.append(staged + (np.array(paths[:n]),
                                          np.array(ws[:n]),
                                          np.array(npaths[:n])))
            return None

        hooks.wrap(DeviceGreedyFused, "solve", before=before, after=after,
                   log="drain_sample")
