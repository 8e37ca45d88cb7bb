"""Helpers the metric readers (metrics/<name>.py) share."""

from __future__ import annotations

# the solve() host clocks in the device stats that metrics read, by
# stage, with the dispatch counter that says the stage ran
# (device_wave.device_stats)
SOLVE_CLOCKS = {"drain": ("fused_device_time", "fused_dispatches"),
                "bridge": ("bridge_device_time", "bridge_dispatches"),
                "ladder": ("ladder_device_time", "ladder_dispatches")}
# every solver's solve() clock in the device stats ends so
SOLVE_SUFFIX = "device_time"


def per_pass(run, fn):
    """The mean over the window's whole passes of fn(pass), leaving out
    passes where fn returns None; None where none is left."""
    vals = [fn(p) for p in run.passes if p.error is None]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def phase_s(name):
    """A reader of the Incubator's seconds in one phase, a pass."""
    return lambda run: per_pass(run, lambda p: p.phases.get(name))


def solve_s(stage):
    """A reader of a stage's solve() host clock, seconds a pass, over the
    passes where it dispatched."""
    clock, count = SOLVE_CLOCKS[stage]
    return lambda run: per_pass(
        run, lambda p: p.stats[clock] if p.stats.get(count, 0) > 0
        else None)


def host_s(p):
    """A pass's region assembly less every solver's solve() clock."""
    if "assemble-regions" not in p.phases:
        return None
    solved = sum(v for k, v in p.stats.items() if k.endswith(SOLVE_SUFFIX))
    return p.phases["assemble-regions"] - solved
