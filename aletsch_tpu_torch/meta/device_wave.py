"""Wave-level orchestration of the device DPs, PyTorch/CUDA port.

Counterpart of aletsch_tpu/meta/device_wave.py.  One region wave's groups
are assembled as paused native GroupRuns (native/core.cpp); every group
whose splice graph pauses for the greedy decomposition (pause kind 1) is
exported into one [64, 64, 64] batch, in one of two modes:

- fused (the default): each graph is exported once in f64, and one launch
  of the drain (ops/greedy_fused.py over ops/drain.py) drains them all.
  The native consumer replays the device paths (trust mode) or re-checks
  them against its own drain (verify mode), so the bytes are the host's
  either way;
- step (ALETSCH_DEVICE_GREEDY=step): each extraction exports the graph's
  current f32 adjacency, one launch of the single-source bottleneck DP
  (ops/greedy_dp.py over ops/bottleneck.py) computes every exported
  graph's table, and the native consumer backtraces one path from each.

A graph the native export refuses (outside [minv, maxv], or a weight set
whose f32 cast is not injective in step mode) is solved by the native host
DP, as in the reference.  Not ported yet, and so refused rather than run
on another path when asked for: the bridge top-K (pause kind 2), the
support reduce (kind 3), the ladder (kind 4), and the measured 'auto'
policy.  In 'off' and 'auto' those stages stay on the native host path,
as the JAX package leaves them on a CPU backend.  Device failures
propagate.
"""

from __future__ import annotations

import os

from ..ops import bottleneck as bottleneck_ops
from ..ops import drain as drain_ops
from ..ops.greedy_dp import DeviceGreedy
from ..ops.greedy_fused import DeviceGreedyFused, device_f64_exact
from ..utils.tracing import TRACE_UNPORTED
from . import native_core

stats = {
    "host_graphs": 0,       # paused graphs solved by the native host DP
    "device_steps": 0,      # device paths consumed (fused: trust mode)
    "waves": 0,
}

_DEVICE = None
_FUSED = None
_FUSED_TRUST = None

# (config field, forcing env var, what is missing and where it is queued)
_UNPORTED = (
    ("device_bridge", "ALETSCH_DEVICE_BRIDGE",
     "the bridge top-K DP, pause kind 2 (ROADMAP Queue 1 item 3)"),
    ("device_support", "ALETSCH_DEVICE_SUPPORT",
     "the support reduce, pause kind 3 (ROADMAP Queue 1 item 4)"),
    ("device_ladder", "ALETSCH_DEVICE_LADDER",
     "the resolution ladder, pause kind 4 (ROADMAP Queue 1 item 6)"),
    ("device_similarity", None,
     "the similarity matmul (ROADMAP Queue 1 item 8)"),
)


def check_supported(cfg):
    """Raise NotImplementedError for a device stage that is forced on but
    not ported yet.  ALETSCH_DEVICE=0 turns every device stage off."""
    if os.environ.get("ALETSCH_DEVICE") == "0":
        return
    for attr, env, what in _UNPORTED:
        if getattr(cfg, attr, "off") == "on" or \
                (env is not None and os.environ.get(env) == "1"):
            raise NotImplementedError(
                "--%s on: %s is not ported to aletsch_tpu_torch yet"
                % (attr, what))
    if getattr(cfg, "jax_profile_dir", ""):
        raise NotImplementedError(TRACE_UNPORTED)


def enabled(cfg, n_groups):
    """Decide whether this wave's greedy decomposition runs on the device,
    fused or in step mode.  'on' or ALETSCH_DEVICE=1 engage it; 'off' and
    'auto' stay on the host ('auto' waits for the crossover model, ROADMAP
    Queue 1 item 5).  Same answer as the JAX package's gate on a CPU
    backend.  The incubator also consults it before it launches a wave
    asynchronously on the host."""
    env = os.environ.get("ALETSCH_DEVICE")
    if env == "0":
        return False
    check_supported(cfg)
    if env != "1" and getattr(cfg, "device_greedy", "off") != "on":
        return False
    require_native()
    return True


def auto_device_ok(cfg, n_graphs=64):
    """Whether the measured crossover model predicts a device win for a
    wave of n_graphs; the 'auto' stages ask (meta/bundle_group.py).  No
    model is ported yet (ROADMAP Queue 1 item 5), so 'auto' stays on the
    host, as the JAX package's does on a CPU backend."""
    return False


def step_mode():
    """ALETSCH_DEVICE_GREEDY=step: one table launch per extraction instead
    of the fused drain (read per wave, as the reference reads it)."""
    return os.environ.get("ALETSCH_DEVICE_GREEDY") == "step"


def require_native():
    """Raise unless the native group assembler and the export the chosen
    greedy mode needs are loaded: the device DP runs inside it, between
    its pauses."""
    if step_mode():
        ok = native_core.native_core_available() and all(
            hasattr(native_core._load_lib(), f)
            for f in ("core_greedy_export", "core_greedy_step"))
        what = "step-mode greedy needs the native core's greedy export"
    else:
        ok = native_core.native_core_available() \
            and native_core.fused_available()
        what = "the device greedy drain needs the native core's fused export"
    if not ok:
        raise RuntimeError("%s (native/libabam.so, built by make -C native)"
                           % what)


def _get_device():
    global _DEVICE
    if _DEVICE is None:
        _DEVICE = DeviceGreedy()
    return _DEVICE


def _get_fused_device():
    global _FUSED, _FUSED_TRUST
    if _FUSED is None:
        _FUSED_TRUST = device_f64_exact()
        _FUSED = DeviceGreedyFused()
    return _FUSED


def device_stats():
    d = dict(stats)
    d["drain_launches"] = drain_ops.drain_cuda.launches
    d["bottleneck_launches"] = bottleneck_ops.bottleneck_cuda.launches
    if _DEVICE is not None:
        d.update(_DEVICE.stats)
    if _FUSED is not None:
        d.update(_FUSED.stats)
        d["fused_trust"] = bool(_FUSED_TRUST)
        d["fused_agree"] = int(native_core.fused_stats[0])
        d["fused_total"] = int(native_core.fused_stats[1])
    return d


def assemble_groups(asms, gvs, cfg):
    """Device-batched equivalent of the serial `asmb.resolve(gv)` loop."""
    step = step_mode()
    if step:
        dev, export = _get_device(), native_core.greedy_export
    else:
        dev, export = _get_fused_device(), native_core.greedy_export_fused
    minv = int(getattr(cfg, "device_min_vertices", 16))
    runs = []               # (asmb, gv, handle-or-None) in group order
    active = []
    for asmb, gv in zip(asms, gvs):
        gh = native_core.start_group_device(asmb, gv, True, minv)
        runs.append((asmb, gv, gh))
        if gh is not None and gh.paused:
            active.append(gh)
    stats["waves"] += 1

    while active:
        nxt = []
        exp = []            # handles with exported rows

        def flush():
            if not exp:
                return
            if step:
                tables = dev.solve(len(exp))
                for i, g in enumerate(exp):
                    stats["device_steps"] += 1
                    if native_core.greedy_step(g, tables[i]):
                        nxt.append(g)
            else:
                paths, ws, npaths = dev.solve(len(exp))
                for i, g in enumerate(exp):
                    if _FUSED_TRUST:
                        stats["device_steps"] += int(npaths[i])
                    if native_core.greedy_consume_fused(
                            g, ws[i], paths[i], int(npaths[i]), dev.maxv,
                            _FUSED_TRUST):
                        nxt.append(g)
            del exp[:]

        for gh in active:
            if gh.pause_kind != 1:
                raise RuntimeError("unexpected native pause kind %d: only "
                                   "the greedy decomposition pauses in the "
                                   "port" % gh.pause_kind)
            if export(gh, dev.row(len(exp)), dev.maxv) <= 0:
                stats["host_graphs"] += 1
                if native_core.greedy_solve_host(gh):
                    nxt.append(gh)
                continue
            exp.append(gh)
            if len(exp) == dev.batch:
                flush()
        flush()
        active = nxt

    # replay in group order (determinism), host path where ineligible
    for asmb, gv, gh in runs:
        if gh is None:
            asmb.resolve(gv)
        else:
            native_core.finish_group_device(gh)
