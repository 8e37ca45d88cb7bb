"""Wave-level orchestration of the device DPs, PyTorch/CUDA port.

Counterpart of aletsch_tpu/meta/device_wave.py.  One region wave's groups
(meta/incubator.py) are assembled concurrently as paused native GroupRuns
(native/core.cpp); the runs pause at four kinds of DP, and the wave batches
each kind across its groups into dispatches on the port's device:

- kind 1, greedy decomposition: every group's currently-active splice
  graph is exported into one [64, 64, 64] batch, in one of two modes.
  Fused (the default): each graph is exported once in f64, and one launch
  of the drain (ops/greedy_fused.py over ops/drain.py) drains them all;
  the native consumer replays the device paths (trust mode) or re-checks
  them against its own drain (verify mode), so the bytes are the host's
  either way.  Step (ALETSCH_DEVICE_GREEDY=step): each extraction exports
  the graph's current f32 adjacency, one launch of the single-source
  bottleneck DP (ops/greedy_dp.py over ops/bottleneck.py) computes every
  exported graph's table, and the native consumer backtraces one path
  from each.
- kind 2, bridging pier DP: each group pauses once per bridging phase with
  every queued (source-run, strand) DP instance of every bundle exported
  together (core.cpp GroupRun::queue_bridge); the wave batches instances
  across groups into [64, ...] dispatches (ops/bridge_topk.py) and feeds
  results back in queue order for the native backtrace and vote.
- kind 3, cross-sample junction support: one [NS, J] row of weights per
  group, summed over the sample axis (ops/support.py).
- kind 4, the scallop resolution ladder: each paused graph's dense
  pre-ladder state is exported, one dispatch runs the resolution-arm
  prefix of every exported graph in lockstep (ops/ladder_device.py over
  ops/ladder_kernel.py), and the native consumer replays the decision
  logs (trust mode) or compares them with its own ladder (verify mode).

Graphs within a group stay strictly sequential (later graphs' cross-sample
supports read earlier graphs' post-greedy state), so the batch axis is the
group axis.  A wave engages when the greedy stage or any of the three
other stages is forced on, and then kind 1 always runs on the device too.
An instance the native export refuses (too small, too large, f32-lossy
weights, over-padded windows) is solved by the native host DP mid-stream;
results are byte-identical either way.

'auto' (every stage's default) asks the measured policy, one fit a stage
(ops/crossover.py): on a card the calibration is read from its cache or
measured once; on the CPU device 'auto' stays on the native host path
without measuring.  'on' and the ALETSCH_DEVICE* variables bypass the
policy.  Device failures propagate: a stage that is forced on and cannot
build its solver raises.
"""

from __future__ import annotations

import os
import sys
import threading

from ..device import ENV as DEVICE_ENV
from ..ops import similarity as similarity_ops
from ..ops.constants import BRIDGE_K as K, BRIDGE_S as S
from . import native_core

stats = {
    "host_graphs": 0,        # paused graphs solved by the native host DP
    "device_steps": 0,       # device paths consumed (fused: trust mode)
    "host_bridge_insts": 0,  # pier-DP instances solved by the host DP
    "device_bridge_insts": 0,  # pier-DP instances consumed from the device
    "host_support_groups": 0,   # support reduces solved by the host sums
    "device_support_groups": 0,  # support reduces consumed from the device
    "host_ladder_graphs": 0,    # ladder-paused graphs solved on host
    "device_ladder_graphs": 0,  # ladder decision logs consumed from device
    "waves": 0,
}

_DEVICE = None
_FUSED = None
_FUSED_TRUST = None
_BRIDGE = None
_SUPPORT = None
_LADDER = None
_LADDER_TRUST = None

_AUTO_CAL = ("unset",)
_AUTO_LOCK = threading.Lock()   # waves are gated on two threads
# what 'auto' answered in this process: {stage: {instances asked about:
# answer}}; device_stats() reports it
policy = {}


def _cpu_device():
    """Whether ALETSCH_TORCH_DEVICE (device.py; default cuda) names the
    CPU, read from the string alone, as the JAX package reads
    JAX_PLATFORMS: nothing imports torch to answer it."""
    return os.environ.get(DEVICE_ENV, "cuda").split(":")[0].strip() == "cpu"


def auto_calibration(cfg):
    """The measured amortization model the 'auto' stages consult: engage
    the card iff a stage's dispatch cost a + b*B beats the native host's
    c*B (ops/crossover.py), with one fit for each stage.  Returns the
    calibration dict, or None where the device path should stay off:

    - the CPU device: the "device" is this host, and a dispatch only adds
      orchestration to the native host path -> None, without measuring,
      reading a cache or creating a CUDA context;
    - a card: the cached calibration of this platform and card (a JSON
      file in the temporary directory, crossover.cache_path()), measured
      once when missing or written for another card.

    Read once a process.  'on' bypasses it (parity runs, fuzz, probes)."""
    global _AUTO_CAL
    with _AUTO_LOCK:
        if _AUTO_CAL == ("unset",):
            if _cpu_device():
                _AUTO_CAL = None
            else:
                from ..ops import crossover
                _AUTO_CAL = crossover.calibration(measure_if_missing=True)
        return _AUTO_CAL


def reset_policy():
    """Forget the calibration and the answers given: the next 'auto'
    question reads the cache again."""
    global _AUTO_CAL
    _AUTO_CAL = ("unset",)
    policy.clear()


def auto_device_ok(cfg, n_graphs=64, stage="drain"):
    """True iff the measured model predicts a device win for `stage` at
    n_graphs instances (crossover.stage_wins: the stage's own fit, and for
    the stages that run inside a device wave the drain's too)."""
    cal = auto_calibration(cfg)
    ok = False
    if cal is not None:
        from ..ops import crossover
        ok = crossover.stage_wins(stage, n_graphs, cal)
    policy.setdefault(stage, {})[int(n_graphs)] = ok
    return ok


def enabled(cfg, n_groups):
    """Decide whether to run this wave through the device path: when the
    greedy stage is 'on' (or ALETSCH_DEVICE=1), when any of bridge, support
    and ladder is enabled for a wave of n_groups, or when the greedy stage
    is 'auto', the wave has device_min_groups groups and the drain's fit
    wins at n_groups.  The incubator also consults it before it launches a
    wave asynchronously on the host."""
    env = os.environ.get("ALETSCH_DEVICE")
    if env == "0":
        return False
    mode = getattr(cfg, "device_greedy", "off")
    if env == "1" or mode == "on" or bridge_enabled(cfg, n_groups) \
            or support_enabled(cfg, n_groups) \
            or ladder_enabled(cfg, n_groups):
        require_native()
        return True
    if mode != "auto" \
            or n_groups < getattr(cfg, "device_min_groups", 16) \
            or not auto_device_ok(cfg, n_groups):
        return False
    require_native()
    return True


def _stage_enabled(cfg, stage, default, available, n):
    """One stage's gate: 'on' or its env var at 1 force it, its env var at
    0 turns it off, 'auto' asks the measured policy about a wave of n
    groups, and answers no without asking below device_min_groups (as the
    drain's gate does), so a wave of few groups never calibrates.  An
    engaged stage whose native pause is missing raises."""
    attr = "device_" + stage
    mode = getattr(cfg, attr, default)
    env = os.environ.get("ALETSCH_DEVICE_" + stage.upper())
    if env == "0":
        return False
    if env == "1" or mode == "on" \
            or (mode == "auto" and n >= getattr(cfg, "device_min_groups", 16)
                and auto_device_ok(cfg, n, stage)):
        if not available():
            raise RuntimeError("--%s on needs the native core's %s pause "
                               "(built from native/ by io/bam_native.py)"
                               % (attr, stage))
        return True
    return False


def bridge_enabled(cfg, n_groups=64):
    """Whether GroupRuns also pause at bridging pier-DP instances.  'auto'
    is asked at the wave's group count, the least a full phase exports."""
    return _stage_enabled(cfg, "bridge", "off",
                          native_core.bridge_pause_available, n_groups)


def support_enabled(cfg, n_groups=64):
    """Whether GroupRuns also pause at the cross-sample junction support
    reduce (ops/support.py): one row a group."""
    return _stage_enabled(cfg, "support", "off",
                          native_core.support_pause_available, n_groups)


def ladder_enabled(cfg, n_groups=64):
    """Whether GroupRuns pause at the scallop resolution ladder (pause
    kind 4; ops/ladder_kernel.py batched over the wave's graphs): at most
    one graph a group in a dispatch."""
    return _stage_enabled(cfg, "ladder", "auto",
                          native_core.ladder_pause_available, n_groups)


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
        raise RuntimeError("%s (built from native/ by io/bam_native.py)"
                           % what)


def _get_device():
    global _DEVICE
    if _DEVICE is None:
        from ..ops.greedy_dp import DeviceGreedy
        _DEVICE = DeviceGreedy()
    return _DEVICE


def _get_fused_device():
    global _FUSED, _FUSED_TRUST
    if _FUSED is None:
        from ..ops.greedy_fused import DeviceGreedyFused, device_f64_exact
        _FUSED_TRUST = device_f64_exact()
        _FUSED = DeviceGreedyFused()
    return _FUSED


def _get_bridge_device():
    global _BRIDGE
    if _BRIDGE is None:
        from ..ops.bridge_topk import DeviceBridge
        _BRIDGE = DeviceBridge()
    return _BRIDGE


def _get_support_device():
    global _SUPPORT
    if _SUPPORT is None:
        from ..ops.support import DeviceSupport
        _SUPPORT = DeviceSupport()
    return _SUPPORT


def _get_ladder_device():
    global _LADDER, _LADDER_TRUST
    if _LADDER is None:
        from ..ops.greedy_fused import device_f64_exact
        from ..ops.ladder_device import DeviceLadder
        _LADDER_TRUST = device_f64_exact()
        _LADDER = DeviceLadder()
    return _LADDER


def reset_solvers():
    """Drop every solver: the next wave builds them anew, probes trust
    again (ALETSCH_FUSED_TRUST is read then) and starts their stats, and the
    similarity forms' counters, at 0."""
    global _DEVICE, _FUSED, _FUSED_TRUST, _BRIDGE, _SUPPORT, _LADDER, \
        _LADDER_TRUST
    _DEVICE = _FUSED = _FUSED_TRUST = _BRIDGE = _SUPPORT = _LADDER = \
        _LADDER_TRUST = None
    for k in similarity_ops.stats:
        similarity_ops.stats[k] = 0


def _launches(module, wrapper):
    """A kernel wrapper's launch count; 0 while its module is not loaded
    (nothing could have launched it), so that reading the stats imports
    no torch."""
    mod = sys.modules.get("aletsch_tpu_torch.ops." + module)
    return getattr(mod, wrapper).launches if mod is not None else 0


def device_stats():
    d = dict(stats)
    d["drain_launches"] = _launches("drain", "drain_cuda")
    d["bottleneck_launches"] = _launches("bottleneck", "bottleneck_cuda")
    for s in (_DEVICE, _FUSED, _BRIDGE, _SUPPORT, _LADDER):
        if s is not None:
            d.update(s.stats)
    d.update(similarity_ops.stats)
    if policy:
        cal = None if _AUTO_CAL == ("unset",) else _AUTO_CAL
        d["auto"] = {"calibrated": cal is not None,
                     "measured_in_s": cal and cal.get("measured_in_s"),
                     "asked": {k: dict(v) for k, v in policy.items()}}
    if _FUSED is not None:
        d["fused_trust"] = bool(_FUSED_TRUST)
        d["fused_agree"] = int(native_core.fused_stats[0])
        d["fused_total"] = int(native_core.fused_stats[1])
    if _LADDER is not None:
        d["ladder_trust"] = bool(_LADDER_TRUST)
        d["ladder_agree"] = int(native_core.ladder_stats[0])
        d["ladder_total"] = int(native_core.ladder_stats[1])
    return d


def assemble_groups(asms, gvs, cfg):
    """Device-batched equivalent of the serial `asmb.resolve(gv)` loop."""
    step = step_mode()
    if step:
        dev, export = _get_device(), native_core.greedy_export
    else:
        dev, export = _get_fused_device(), native_core.greedy_export_fused
    bridge_dev = bridge_enabled(cfg, len(asms))
    bdev = _get_bridge_device() if bridge_dev else None
    support_dev = support_enabled(cfg, len(asms))
    sdev = _get_support_device() if support_dev else None
    ladder_dev = ladder_enabled(cfg, len(asms))
    ldev = _get_ladder_device() if ladder_dev else None
    minv = int(getattr(cfg, "device_min_vertices", 16))
    runs = []               # (asmb, gv, handle-or-None) in group order
    active = []
    for asmb, gv in zip(asms, gvs):
        gh = native_core.start_group_device(asmb, gv, True, minv,
                                            bridge_dev, support_dev,
                                            ladder_dev)
        runs.append((asmb, gv, gh))
        if gh is not None and gh.paused:
            active.append(gh)
    stats["waves"] += 1

    while active:
        nxt = []
        g_exp = []          # greedy-paused handles with exported rows
        s_exp = []          # support-paused handles with exported rows
        l_exp = []          # ladder-paused handles with exported rows

        def flush_ladder():
            if not l_exp:
                return
            larm, ltgt, ndec, lstatus = ldev.solve(len(l_exp))
            for i, g in enumerate(l_exp):
                stats["device_ladder_graphs"] += 1
                if native_core.ladder_consume(
                        g, larm[i], ltgt[i], int(ndec[i]),
                        int(lstatus[i]), _LADDER_TRUST):
                    nxt.append(g)
            del l_exp[:]

        def flush_greedy():
            if not g_exp:
                return
            if step:
                tables = dev.solve(len(g_exp))
                for i, g in enumerate(g_exp):
                    stats["device_steps"] += 1
                    if native_core.greedy_step(g, tables[i]):
                        nxt.append(g)
            else:
                paths, ws, npaths = dev.solve(len(g_exp))
                for i, g in enumerate(g_exp):
                    if _FUSED_TRUST:
                        stats["device_steps"] += int(npaths[i])
                    if native_core.greedy_consume_fused(
                            g, ws[i], paths[i], int(npaths[i]), dev.maxv,
                            _FUSED_TRUST):
                        nxt.append(g)
            del g_exp[:]

        b_results = []      # per exported instance: (ostk, par, pix)
        b_cur = []          # result slots filled in the current dispatch
        b_feed = []         # (handle, plan); plan entry = slot id or -1

        def flush_bridge_rows():
            if not b_cur:
                return
            ostk, par, pix = bdev.solve(len(b_cur))
            for i, sl in enumerate(b_cur):
                b_results[sl] = (ostk[i], par[i], pix[i])
            del b_cur[:]

        def feed_bridges():
            # feed every queued instance back in flattened queue order
            # (the native consume order; see core.cpp bridge_export_at)
            flush_bridge_rows()
            for g, plan in b_feed:
                kind = g.pause_kind
                for sl in plan:
                    if sl >= 0:
                        ostk, par, pix = b_results[sl]
                        stats["device_bridge_insts"] += 1
                        kind = native_core.bridge_step(g, ostk, par, pix,
                                                       K, S)
                    else:
                        stats["host_bridge_insts"] += 1
                        kind = native_core.bridge_solve_host(g)
                if kind:
                    nxt.append(g)
            del b_feed[:]
            del b_results[:]

        def flush_support():
            if not s_exp:
                return
            sums = sdev.solve(len(s_exp))
            for i, g in enumerate(s_exp):
                stats["device_support_groups"] += 1
                if native_core.support_step(g, sums[i]):
                    nxt.append(g)
            del s_exp[:]

        for gh in active:
            if gh.pause_kind == 4:
                v = native_core.ladder_export(
                    gh, ldev.row(len(l_exp)), ldev.maxv, ldev.maxe,
                    ldev.maxh, ldev.maxl, ldev.dmax) if ladder_dev else 0
                if v <= 0:
                    stats["host_ladder_graphs"] += 1
                    if native_core.ladder_solve_host(gh):
                        nxt.append(gh)
                    continue
                l_exp.append(gh)
                if len(l_exp) == ldev.batch:
                    flush_ladder()
                continue
            if gh.pause_kind == 3:
                v = native_core.support_export(
                    gh, sdev.row(len(s_exp))) if support_dev else 0
                if v <= 0:
                    stats["host_support_groups"] += 1
                    if native_core.support_solve_host(gh):
                        nxt.append(gh)
                    continue
                s_exp.append(gh)
                if len(s_exp) == sdev.batch:
                    flush_support()
                continue
            if gh.pause_kind == 2:
                # one pause covers the whole bridging phase: export every
                # queued pier-DP instance now, feed them all after the
                # batched dispatch(es)
                plan = []
                for j in range(native_core.bridge_pending(gh)):
                    v = native_core.bridge_export_at(
                        gh, j, bdev.row(len(b_cur)), K, S) \
                        if bridge_dev else 0
                    if v > 0:
                        plan.append(len(b_results))
                        b_cur.append(len(b_results))
                        b_results.append(None)
                        if len(b_cur) == bdev.batch:
                            flush_bridge_rows()
                    else:
                        plan.append(-1)
                b_feed.append((gh, plan))
                continue
            if gh.pause_kind != 1:
                raise RuntimeError("unexpected native pause kind %d"
                                   % gh.pause_kind)
            if export(gh, dev.row(len(g_exp)), dev.maxv) <= 0:
                stats["host_graphs"] += 1
                if native_core.greedy_solve_host(gh):
                    nxt.append(gh)
                continue
            g_exp.append(gh)
            if len(g_exp) == dev.batch:
                flush_greedy()
        flush_greedy()
        feed_bridges()
        flush_support()
        flush_ladder()
        active = nxt

    # replay in group order (determinism), host path where ineligible
    for asmb, gv, gh in runs:
        if gh is None:
            asmb.resolve(gv)
        else:
            native_core.finish_group_device(gh)
