"""Readers of the program's spans and sync clocks (metrics/<name>.py),
each seconds a pass: the spans are in a pass's phases (the program's
Tracer.span adds them to Tracer.phase_times beside the phases), the sync
clocks in its device stats.  A program without them (an older one) gives
no value: each reader returns None and raises nothing."""

from __future__ import annotations

from bmk.readers import SOLVE_SUFFIX, per_pass

# a stage's sync clock in the device stats, with the dispatch counter
# that says the stage ran
SYNC_CLOCKS = {"drain": ("fused_sync_time", "fused_dispatches"),
               "bridge": ("bridge_sync_time", "bridge_dispatches"),
               "ladder": ("ladder_sync_time", "ladder_dispatches")}


def span_s(name):
    """A reader of one span's seconds a pass."""
    return lambda run: per_pass(run, lambda p: p.phases.get(name))


def pass_native_s(p):
    """A pass's native calls inside its waves: wave.start, every
    wave.consume.<stage> and wave.finish."""
    if "wave.start" not in p.phases:
        return None
    return sum(v for k, v in p.phases.items()
               if k in ("wave.start", "wave.finish")
               or k.startswith("wave.consume."))


def pass_python_s(p):
    """A pass's waves less their native calls, exports, host DPs and every
    solver's solve() clock: the Python orchestration's own time."""
    native = pass_native_s(p)
    if native is None or "wave" not in p.phases:
        return None
    solved = sum(v for k, v in p.stats.items() if k.endswith(SOLVE_SUFFIX))
    return p.phases["wave"] - native - p.phases.get("wave.export", 0.0) \
        - p.phases.get("wave.host_dp", 0.0) - solved


def native_s(run):
    return per_pass(run, pass_native_s)


def python_s(run):
    return per_pass(run, pass_python_s)


def sync_s(stage):
    """A reader of a stage's sync clock, seconds a pass, over the passes
    where it dispatched."""
    clock, count = SYNC_CLOCKS[stage]
    return lambda run: per_pass(
        run, lambda p: p.stats.get(clock) if p.stats.get(count, 0) > 0
        else None)
