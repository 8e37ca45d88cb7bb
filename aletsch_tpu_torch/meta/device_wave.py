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
  across groups into [64, ...] dispatches (ops/bridge_topk.py: on a card
  one launch of csrc/bridge.cu) and feeds results back in queue order for
  the native backtrace and vote.
- kind 3, cross-sample junction support: one [NS, J] row of weights per
  group, summed over the sample axis (ops/support.py).
- kind 4, the scallop resolution ladder: each paused graph's dense
  pre-ladder state is exported, one dispatch runs the resolution-arm
  prefix of every exported graph in lockstep (ops/ladder_device.py over
  ops/ladder_kernel.py), and the native consumer replays the decision
  logs (trust mode) or compares them with its own ladder (verify mode).

The incubator's replay thread runs the waves of consecutive regions
queued together, up to one staging batch of groups, as one wave
(meta/incubator.py ReplayQueue), so a round ships one dispatch a stage
for all of them.

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

import ctypes
import os
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np

from ..device import ENV as DEVICE_ENV
from ..ops import similarity as similarity_ops
from ..ops.constants import (BRIDGE_B, BRIDGE_K as K, BRIDGE_S as S,
                             DRAIN_B, LADDER_B, STEP_B, SUPPORT_B)
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
    # the wave pool (csrc/wave_pool.cpp): batches of two or more runs
    # advanced on it and the runs in them; batches run on the calling
    # thread (of one run, or every batch where the pool has no thread: -t
    # 1); runs launched from the main thread before their wave
    # (meta/incubator.py _region_start)
    "pool_calls": 0,
    "pool_handles": 0,
    "inline_advances": 0,
    "prestarted_groups": 0,
    # calls of assemble_groups that ran the device waves of two regions or
    # more together (meta/incubator.py ReplayQueue.get), and the region
    # waves in them
    "merge_calls": 0,
    "merged_waves": 0,
}
_STATS_LOCK = threading.Lock()  # the main thread counts launches
# the stages whose refused graphs or instances a wave solves by the native
# host DP, each with its clock wave.host_dp.<stage> (drain: the greedy
# stage, fused or step)
HOST_DP_STAGES = ("drain", "bridge", "support", "ladder")

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
    d["ladder_launches"] = _launches("ladder_kernel", "ladder_cuda")
    d["bridge_launches"] = _launches("bridge_topk", "bridge_cuda")
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
    d["pool_task_s"] = pool_task_seconds()
    return d


# ------------------------------------------------------------- the wave pool
# One pool of native threads a process (csrc/wave_pool.cpp), made on the
# first batch that reaches it, advances the paused GroupRuns of a wave
# together: each wave's first advances (launch(), from the main thread
# where the incubator launches the wave early) and each flush's resumes
# after a solve() (_resume()).  A task is the serial path's own call of the
# native core on one run, and runs touch only their own state, so the bytes
# and every dispatch are the serial path's.

_POOL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "wave_pool.cpp")
_POOL_FLAGS = ("-std=c++14", "-O2", "-pthread", "-shared", "-fPIC")
# the native core's entry points, in wave_bind's order
_POOL_CORE = ("core_group_start", "core_group_set_ladder",
              "core_group_advance", "core_greedy_consume_fused",
              "core_greedy_step", "core_ladder_consume", "core_support_step",
              "core_bridge_step")
_POOL = None                # (the core library bound, the pool's library)
_POOL_LOCK = threading.Lock()


def add_stats(**kw):
    with _STATS_LOCK:
        for k, v in kw.items():
            stats[k] += v


def pool_width(cfg):
    """The wave pool's threads for this run: -t and the host's cores, less
    one core for the main and replay threads, as the host path's async pool
    is sized (meta/incubator.py _region_start); 0 at -t 1."""
    return max(0, min(cfg.max_threads, os.cpu_count() or 1) - 1)


def _build_pool(build_dir=None):
    """Path of the pool's library, built with g++ from csrc/wave_pool.cpp
    into build/aletsch_tpu_torch/ (io/bam_native.py's build directory),
    named by a hash of the source and the flags.  The first process to need
    it builds it under an exclusive lock and renames it into place, so a
    file at that path is always complete.  Raises when g++ fails."""
    import fcntl
    import hashlib
    import subprocess
    import tempfile
    from ..io.bam_native import _BUILD_DIR
    build_dir = _BUILD_DIR if build_dir is None else build_dir
    with open(_POOL_SRC, "rb") as fh:
        h = hashlib.sha256(" ".join(_POOL_FLAGS).encode() + b"\0"
                           + fh.read())
    out = os.path.join(build_dir, "libwave_pool_%s.so" % h.hexdigest()[:16])
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(out + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)    # released when the file closes
        if not os.path.exists(out):
            with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
                lib = os.path.join(tmp, "libwave_pool.so")
                subprocess.run(["g++", *_POOL_FLAGS, "-o", lib, _POOL_SRC],
                               check=True, capture_output=True)
                os.replace(lib, out)
    return out


def _pool_lib():
    """The pool's library, its entry points declared and bound to the
    native core's (again where the core's library was loaded anew)."""
    global _POOL
    core = native_core._load_lib()
    native_core._bind(core)
    with _POOL_LOCK:
        if _POOL is not None and _POOL[0] is core:
            return _POOL[1]
        lib = _POOL[1] if _POOL is not None else ctypes.CDLL(_build_pool())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        for name, args in (
                ("wave_consume_fused",
                 [i32, vp, vp, i64, vp, i64, vp, i32, i32, vp, vp, i32]),
                ("wave_greedy_step", [i32, vp, vp, i64, vp, i32]),
                ("wave_ladder_consume",
                 [i32, vp, vp, i64, vp, i64, vp, vp, i32, vp, vp, i32]),
                ("wave_support_step", [i32, vp, vp, i64, vp, i32]),
                ("wave_bridge_feed",
                 [i32, vp, vp, vp, vp, vp] + [i32] * 4 + [vp, i32]),
                ("wave_join", [vp])):
            fn = getattr(lib, name)
            fn.restype = i32
            fn.argtypes = args
        lib.wave_start_async.restype = vp
        lib.wave_start_async.argtypes = \
            core.core_resolve_groups_mt.argtypes + [i32] * 6 + [vp, vp]
        lib.wave_task_ns.restype = i64
        lib.wave_task_ns.argtypes = []
        lib.wave_bind.argtypes = [vp]
        fns = (vp * len(_POOL_CORE))(*(
            ctypes.cast(getattr(core, name), vp).value
            for name in _POOL_CORE))
        lib.wave_bind(fns)
        _POOL = (core, lib)
        return lib


def pool_task_seconds():
    """Seconds the wave pool's tasks took, on every thread, since the
    process began (0 before its first batch)."""
    return _POOL[1].wave_task_ns() / 1e9 if _POOL is not None else 0.0


def _free(runs):
    """Free every run of [(asmb, gv, handle-or-None)] not yet finished."""
    lib = native_core._load_lib()
    for _, _, gh in runs:
        if gh is not None and gh.h is not None:
            lib.core_group_free(gh.h)
            gh.h = None
            gh.keep = None


class Started:
    """A wave's runs as launch() started them: `runs` as assemble_groups
    holds them once join() returns, the stage flags they were made with,
    and, while the pool makes and advances them, its job."""

    __slots__ = ("runs", "flags", "lib", "job", "elig", "hs", "kinds",
                 "keep")

    def __init__(self, runs, flags, lib):
        self.runs = runs
        self.flags = flags
        self.lib = lib
        self.job = self.elig = self.hs = self.kinds = self.keep = None

    def _join(self):
        """Wait for the pool's job (once), and hand each run made to its
        group's handle; whether every task ran."""
        job, self.job = self.job, None
        ok = self.lib.wave_join(job) == 0
        _, keep = self.keep
        for g, h, kind in zip(self.elig, self.hs.tolist(),
                               self.kinds.tolist()):
            if h:
                asmb, gv, _ = self.runs[g]
                self.runs[g] = (asmb, gv, native_core.GroupHandle(
                    h, asmb, gv, keep, kind))
        self.keep = None
        return ok

    def join(self):
        """The runs, each advanced to its first pause."""
        if self.job is not None and not self._join():
            raise RuntimeError("a native group run failed on the wave pool")
        return self.runs

    def discard(self):
        """Free the runs of a wave that will not run (a failure), once the
        pool is done with them."""
        if self.job is not None:
            self._join()
        _free(self.runs)


def launch(asms, gvs, cfg):
    """Start a device wave: marshal its eligible groups in one batch (the
    host path's marshal, native_core._marshal_batch) and hand them to the
    wave pool, which makes each group's run with the stage flags the wave
    will use and advances it to its first pause, while this returns.  A
    batch of one, or any batch at -t 1, runs in Started.join() on the
    joining thread.  Returns the Started record for assemble_groups."""
    width = pool_width(cfg)
    lib = _pool_lib()
    n = len(asms)
    flags = (bridge_enabled(cfg, n), support_enabled(cfg, n),
             ladder_enabled(cfg, n))
    st = Started([(asmb, gv, None) for asmb, gv in zip(asms, gvs)], flags,
                 lib)
    elig = [g for g, (asmb, gv) in enumerate(zip(asms, gvs))
            if native_core.eligible(asmb, gv)]
    if not elig:
        return st
    st.elig = elig
    # the arrays the pool's tasks read, and the payloads the runs point into
    st.keep = native_core._marshal_batch(
        [asms[g] for g in elig], [gvs[g] for g in elig], True, width)
    st.hs = np.zeros(len(elig), dtype=np.uintp)
    st.kinds = np.zeros(len(elig), dtype=np.int32)
    st.job = lib.wave_start_async(
        *st.keep[0], native_core.CFG_NI, native_core.CFG_ND,
        int(getattr(cfg, "device_min_vertices", 16)),
        *(int(f) for f in flags), st.hs.ctypes.data, st.kinds.ctypes.data)
    if len(elig) > 1 and width > 0:
        add_stats(pool_calls=1, pool_handles=len(elig))
    else:
        add_stats(inline_advances=1)
    return st


# ------------------------------------------------------- merged region waves
# The groups of one merged call: a staging batch of every stage's solver,
# so that a round of a merged call ships one dispatch a stage.
MERGE_GROUPS = min(DRAIN_B, STEP_B, BRIDGE_B, SUPPORT_B, LADDER_B)


def merges(flags, groups, other_flags, other_groups):
    """Whether a device wave of other_groups groups, started with
    other_flags, joins a call of `groups` groups started with `flags`
    (meta/incubator.py ReplayQueue.get): the same stage flags, and one
    staging batch of groups at most."""
    return other_flags == flags and groups + other_groups <= MERGE_GROUPS


def _resume(hs, width, call):
    """Resume one flush's runs after a solve(): each run's consume feeds
    its row and advances it to its next pause, through
    call(lib, run addresses, kinds address), a wave_* batch
    (csrc/wave_pool.cpp) whose tasks are the serial path's native calls.
    A batch of one, or every batch where the pool has no thread (-t 1),
    runs on this thread without a handoff; a larger one on the wave pool,
    this thread running tasks too.  Returns the pause kinds in the handles'
    order."""
    n = len(hs)
    if n == 0:
        return []
    kinds = np.zeros(n, dtype=np.int32)
    addrs = np.array([gh.h for gh in hs], dtype=np.uintp)
    if call(_pool_lib(), addrs.ctypes.data, kinds.ctypes.data) != 0:
        raise RuntimeError("a native group run failed on the wave pool")
    if n > 1 and width > 0:
        add_stats(pool_calls=1, pool_handles=n)
    else:
        add_stats(inline_advances=1)
    out = kinds.tolist()
    for gh, k in zip(hs, out):
        gh.pause_kind = k
    return out


def _rows(a, dtype, n):
    """The first n rows of a solver's output as one C-contiguous array,
    and its row stride in elements."""
    a = np.ascontiguousarray(a[:n], dtype=dtype)
    return a, a.strides[0] // a.itemsize


def _consume_fused(hs, paths, ws, npaths, maxv, trust, width):
    def call(lib, hp, kp):
        n = len(hs)
        w, ws_stride = _rows(ws, np.float64, n)
        p = np.ascontiguousarray(paths[:n]).view(np.uint8)  # bool rows
        c = np.ascontiguousarray(npaths[:n], dtype=np.int32)
        st = np.zeros((n, 2), dtype=np.int64)
        rc = lib.wave_consume_fused(
            n, hp, w.ctypes.data, ws_stride, p.ctypes.data, p.strides[0],
            c.ctypes.data, maxv, 0 if trust else 1, st.ctypes.data, kp,
            width)
        native_core.fused_stats += st.sum(axis=0)
        return rc
    return _resume(hs, width, call)


def _greedy_step(hs, tables, width):
    def call(lib, hp, kp):
        t, stride = _rows(tables, np.float32, len(hs))
        return lib.wave_greedy_step(len(hs), hp, t.ctypes.data, stride, kp,
                                    width)
    return _resume(hs, width, call)


def _consume_ladder(hs, larm, ltgt, ndec, status, trust, width):
    def call(lib, hp, kp):
        n = len(hs)
        arm, arm_stride = _rows(larm, np.int32, n)
        tgt, tgt_stride = _rows(ltgt, np.int32, n)
        nd = np.ascontiguousarray(ndec[:n], dtype=np.int32)
        ss = np.ascontiguousarray(status[:n], dtype=np.int32)
        st = np.zeros((n, 2), dtype=np.int64)
        rc = lib.wave_ladder_consume(
            n, hp, arm.ctypes.data, arm_stride, tgt.ctypes.data, tgt_stride,
            nd.ctypes.data, ss.ctypes.data, 0 if trust else 1,
            st.ctypes.data, kp, width)
        native_core.ladder_stats += st.sum(axis=0)
        return rc
    return _resume(hs, width, call)


def _support_step(hs, sums, width):
    def call(lib, hp, kp):
        s, stride = _rows(sums, np.float32, len(hs))
        return lib.wave_support_step(len(hs), hp, s.ctypes.data, stride,
                                     kp, width)
    return _resume(hs, width, call)


def _feed_bridges(feeds, outs, slots, width):
    """Feed each run of feeds, [(handle, plan)], every queued instance in
    queue order: plan holds the instances' slots, slots[slot] = (dispatch,
    row) and outs[dispatch] = (ostk, par, pix), int32 C-contiguous."""
    def call(lib, hp, kp):
        base = [tuple((a.ctypes.data, a.strides[0]) for a in out)
                for out in outs]
        off = [0]
        ptrs = ([], [], [])
        for _, plan in feeds:
            for sl in plan:
                d, i = slots[sl]
                for col, (addr, stride) in zip(ptrs, base[d]):
                    col.append(addr + i * stride)
            off.append(len(ptrs[0]))
        off = np.array(off, dtype=np.int64)
        po, pp, px = (np.array(c, dtype=np.uintp) for c in ptrs)
        ostk, par, _ = outs[0]
        return lib.wave_bridge_feed(
            len(feeds), hp, off.ctypes.data, po.ctypes.data, pp.ctypes.data,
            px.ctypes.data, par.shape[1], ostk.shape[1], K, S, kp, width)
    return _resume([g for g, _ in feeds], width, call)


def _no_span(name, region=None):
    return nullcontext()


def _no_clock():
    return 0.0


def assemble_groups(asms, gvs, cfg, tracer=None, started=None):
    """Device-batched equivalent of the serial `asmb.resolve(gv)` loop.

    started: the Started records of one region's wave or more, as launch()
    started them on the main thread with one stage flags; without them the
    wave launches its runs here.  Several records run the device waves of
    consecutive regions as one wave (the replay thread's merged call,
    meta/incubator.py ReplayQueue.get): asms and gvs hold their groups
    joined in region order, every round exports the runs of all of them
    into the same staging rows, and wave.finish takes the runs in that
    order, so each region's groups finish in their own order.
    stats["waves"] counts each region's wave.  Each flush's resumes after a
    solve() go to the wave pool together (_resume); their pause kinds join
    the next round in the serial order, so every dispatch holds the rows it
    held serially.  A failure frees every run not yet finished, after the
    pool is done with them.

    With the incubator's tracer it times the wave's parts as spans
    (utils/tracing.py), inside the caller's span `wave` around this call:
    `wave.start` (the runs' starts, or the join of a wave launched early),
    each `wave.round` of the pause loop, `wave.consume.<stage>` (the native
    consumes after a stage's solve(), which resume the runs to their next
    pause) and `wave.finish`; and as clocks only, summed a wave,
    `wave.export` (every export into staging rows) and `wave.host_dp`
    (every native host DP of a refused instance), the latter split by
    stage into `wave.host_dp.<stage>` (drain, bridge, support, ladder),
    which sum to it.  Their seconds are disjoint: the bridge's consume
    span leaves out the host DPs fed in among its consumes.  Without a
    tracer it times nothing."""
    span = _no_span if tracer is None else tracer.span
    waves = list(started or ())
    runs = []               # (asmb, gv, handle-or-None) in group order
    try:
        with span("wave.start"):
            if not waves:
                waves.append(launch(asms, gvs, cfg))
            for st in waves:
                runs.extend(st.join())
        if len(waves) > 1:
            stats["merge_calls"] += 1
            stats["merged_waves"] += len(waves)
        _assemble(cfg, tracer, waves[0].flags, runs, len(waves))
    except BaseException:
        for st in waves:
            st.discard()
        _free(runs)
        raise


def _assemble(cfg, tracer, flags, runs, nwaves):
    step = step_mode()
    if step:
        dev, export = _get_device(), native_core.greedy_export
    else:
        dev, export = _get_fused_device(), native_core.greedy_export_fused
    bridge_dev, support_dev, ladder_dev = flags
    bdev = _get_bridge_device() if bridge_dev else None
    sdev = _get_support_device() if support_dev else None
    ldev = _get_ladder_device() if ladder_dev else None
    width = pool_width(cfg)
    greedy = "wave.consume.step" if step else "wave.consume.drain"
    if tracer is None:
        span, clock = _no_span, _no_clock
    else:
        span, clock = tracer.span, time.perf_counter
    t_exp = 0.0             # seconds in exports
    t_dp = dict.fromkeys(HOST_DP_STAGES, 0.0)   # in host DPs, by stage
    active = [gh for _, _, gh in runs if gh is not None and gh.paused]
    stats["waves"] += nwaves

    while active:
        nxt = []
        g_exp = []          # greedy-paused handles with exported rows
        s_exp = []          # support-paused handles with exported rows
        l_exp = []          # ladder-paused handles with exported rows

        def resumed(hs, kinds):
            nxt.extend(g for g, k in zip(hs, kinds) if k)

        def flush_ladder():
            if not l_exp:
                return
            larm, ltgt, ndec, lstatus = ldev.solve(len(l_exp))
            with span("wave.consume.ladder"):
                stats["device_ladder_graphs"] += len(l_exp)
                resumed(l_exp, _consume_ladder(l_exp, larm, ltgt, ndec,
                                               lstatus, _LADDER_TRUST, width))
            del l_exp[:]

        def flush_greedy():
            if not g_exp:
                return
            if step:
                tables = dev.solve(len(g_exp))
                with span(greedy):
                    stats["device_steps"] += len(g_exp)
                    resumed(g_exp, _greedy_step(g_exp, tables, width))
            else:
                paths, ws, npaths = dev.solve(len(g_exp))
                with span(greedy):
                    if _FUSED_TRUST:
                        stats["device_steps"] += int(
                            np.sum(npaths[:len(g_exp)]))
                    resumed(g_exp, _consume_fused(g_exp, paths, ws, npaths,
                                                  dev.maxv, _FUSED_TRUST,
                                                  width))
            del g_exp[:]

        b_outs = []         # each bridge dispatch's (ostk, par, pix)
        b_results = []      # per exported instance: (dispatch, row)
        b_cur = []          # result slots filled in the current dispatch
        b_feed = []         # (handle, plan); plan entry = slot id or -1

        def flush_bridge_rows():
            if not b_cur:
                return
            b_outs.append(tuple(np.ascontiguousarray(a, dtype=np.int32)
                                for a in bdev.solve(len(b_cur))))
            for i, sl in enumerate(b_cur):
                b_results[sl] = (len(b_outs) - 1, i)
            del b_cur[:]

        def feed_bridges():
            # feed every queued instance back in flattened queue order
            # (the native consume order; see core.cpp bridge_export_at):
            # the runs whose instances all have device rows together, the
            # others here with the host DP of each refused instance
            flush_bridge_rows()
            if not b_feed:
                return
            dp = 0.0
            with span("wave.consume.bridge"):
                whole = [k for k, (_, plan) in enumerate(b_feed)
                         if plan and min(plan) >= 0]
                feeds = [b_feed[k] for k in whole]
                stats["device_bridge_insts"] += sum(len(p) for _, p in feeds)
                kinds = dict(zip(whole, _feed_bridges(feeds, b_outs,
                                                      b_results, width)))
                for k, (g, plan) in enumerate(b_feed):
                    kind = kinds.get(k)
                    if kind is None:
                        kind = g.pause_kind
                        for sl in plan:
                            if sl >= 0:
                                d, i = b_results[sl]
                                ostk, par, pix = b_outs[d]
                                stats["device_bridge_insts"] += 1
                                kind = native_core.bridge_step(
                                    g, ostk[i], par[i], pix[i], K, S)
                            else:
                                stats["host_bridge_insts"] += 1
                                t = clock()
                                kind = native_core.bridge_solve_host(g)
                                dp += clock() - t
                    if kind:
                        nxt.append(g)
            if tracer is not None:
                tracer.add_time("wave.consume.bridge", -dp)
            t_dp["bridge"] += dp
            del b_feed[:]
            del b_results[:]
            del b_outs[:]

        def flush_support():
            if not s_exp:
                return
            sums = sdev.solve(len(s_exp))
            with span("wave.consume.support"):
                stats["device_support_groups"] += len(s_exp)
                resumed(s_exp, _support_step(s_exp, sums, width))
            del s_exp[:]

        with span("wave.round"):
            for gh in active:
                if gh.pause_kind == 4:
                    t = clock()
                    v = native_core.ladder_export(
                        gh, ldev.row(len(l_exp)), ldev.maxv, ldev.maxe,
                        ldev.maxh, ldev.maxl, ldev.dmax) \
                        if ladder_dev else 0
                    t_exp += clock() - t
                    if v <= 0:
                        stats["host_ladder_graphs"] += 1
                        t = clock()
                        more = native_core.ladder_solve_host(gh)
                        t_dp["ladder"] += clock() - t
                        if more:
                            nxt.append(gh)
                        continue
                    l_exp.append(gh)
                    if len(l_exp) == ldev.batch:
                        flush_ladder()
                    continue
                if gh.pause_kind == 3:
                    t = clock()
                    v = native_core.support_export(
                        gh, sdev.row(len(s_exp))) if support_dev else 0
                    t_exp += clock() - t
                    if v <= 0:
                        stats["host_support_groups"] += 1
                        t = clock()
                        more = native_core.support_solve_host(gh)
                        t_dp["support"] += clock() - t
                        if more:
                            nxt.append(gh)
                        continue
                    s_exp.append(gh)
                    if len(s_exp) == sdev.batch:
                        flush_support()
                    continue
                if gh.pause_kind == 2:
                    # one pause covers the whole bridging phase: export
                    # every queued pier-DP instance now, feed them all
                    # after the batched dispatch(es)
                    plan = []
                    for j in range(native_core.bridge_pending(gh)):
                        t = clock()
                        v = native_core.bridge_export_at(
                            gh, j, bdev.row(len(b_cur)), K, S) \
                            if bridge_dev else 0
                        t_exp += clock() - t
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
                t = clock()
                v = export(gh, dev.row(len(g_exp)), dev.maxv)
                t_exp += clock() - t
                if v <= 0:
                    stats["host_graphs"] += 1
                    t = clock()
                    more = native_core.greedy_solve_host(gh)
                    t_dp["drain"] += clock() - t
                    if more:
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
    with span("wave.finish"):
        for asmb, gv, gh in runs:
            if gh is None:
                asmb.resolve(gv)
            else:
                native_core.finish_group_device(gh)
    if tracer is not None:
        tracer.add_time("wave.export", t_exp)
        tracer.add_time("wave.host_dp", sum(t_dp.values()))
        for stage, dp in t_dp.items():
            tracer.add_time("wave.host_dp." + stage, dp,
                            parent="wave.host_dp")
