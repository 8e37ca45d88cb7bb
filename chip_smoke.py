#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (aletsch_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py [--kernels-only | --phases 3e,3f,3g,3h,3i,3j]

Phases, each of which exits non-zero on failure:
1. environment: the card's name and power limit, the kernel build from
   aletsch_tpu_torch/csrc with nvcc (sm_90a) and what ptxas reports for
   each kernel, the kernel library's CUDA runtime (ldd: libcudart.so,
   the one torch has loaded, the same version), the native host core: the
   port's own build and, beside it, native/libabam.so for the reference
   CLI;
2. kernel vs plain: the drain kernel against its plain PyTorch version on
   the card and on the host CPU (IEEE f64), bit for bit in f64 (ws
   compared as int64 views) and against the plain version on the card in
   f32, on fuzz batches (random and full-width graphs at V = 64, and
   tie-heavy batches at V = 64 and 33: equal candidates with different P,
   sinks below and above 32 and before the last vertex, rows with no path
   to the sink) and edge cases; then, at the main path's shapes, the
   kernel's device time (CUDA events with the host's launch cost held
   outside the window, and the profiler's kernel time: one record a
   launch, within EVENT_GAP_MS and EVENT_SPREAD of the events' time), the
   wrapper call's time, the plain version's call time, and the kernel's
   roofline bound with the share of it reached;
2b. bottleneck kernel vs plain: the single-source bottleneck kernel
   (csrc/bottleneck.cu) in both forms against its plain PyTorch version
   on the card and on the host CPU, bit for bit on int32 views with -0.0
   turned into +0.0 (the consumer reads values only), on fuzz batches with
   0.0 and -0.0 edges and unreachable vertices at V = 16, 33 and 64, with
   and without entries on and below the diagonal (which the DP must
   ignore), and the edge cases; its own path, bottleneck_from_source(
   version=1 and 2), driven with every launch count reset; then its times
   and bound, measured as the drain's;
2c. the three XLA programs of the reference, on the card against their
   oracles at the production shapes, exactly: the bridge top-K DP's
   hand-written kernel (csrc/bridge.cu, bridge_cuda) against its plain
   form (bridge_plain) on the card and on the host CPU, and the host
   CPU's against the numpy oracle, every output element for element at
   1, 3, 37 and 64 rows, on random DAG windows and a tie-heavy batch at
   the production shape and a tie-heavy batch at the CPU tests' shape;
   what ptxas reported for it; its profiling instance (bridge_profile)
   at 64 rows of the random and the tie-heavy production-shape batches,
   equal to the kernel, with each pass's cycles; its device time, the
   wrapper call's time, the plain form's time on the card (at 1 and 37
   rows) and its bound at each row count; then its solver
   (DeviceBridge.solve: one copy in, one launch, one copy out a dispatch,
   the live rows only) against the oracle, with exactly 3 device records
   a dispatch under the profiler at each row count and the traced
   dispatch's split (_dispatch_split); the support reduce
   (plain PyTorch) against its numpy oracle; the resolution ladder's
   hand-written kernel (csrc/ladder.cu, ladder_cuda) against its plain
   form (ladder_plain) on the card and on the host CPU, every output and
   the per-graph event counts bit for bit (ewrt on int64 views), at 1, 3,
   55 and 64 rows, on seeded states (ops/ladder_kernel.py::fuzz_states)
   at the CPU tests' small shape and at the production shape and on the
   first 64 ladder fixtures (tests/fixtures/ladder) at the production
   shape, and its logs against the dense reference machine
   (ops/ladder_ref.py) decision for decision; what ptxas reported for the
   kernel; its device time (CUDA events and the profiler), the wrapper
   call's time and its bound at each row count on the fuzz states (the
   plain form's time on the card at 3 and 64 rows), and its device time
   and bound on the fixtures; its profiling instance (ladder_profile) at 3 and 64 rows of
   both, equal to the kernel in every output, with each pass's cycles an
   event, overall and by arm; then the solver (DeviceLadder.solve: one
   copy in, one launch, one copy out a dispatch) against the kernel, 3
   device records a dispatch and its split, as the bridge's.  Both
   solvers over the mesh emulated as two and as three cuda:0 devices
   (ops/meshing.py's split and replicated branches) at 1, 3, 37 and 64
   rows, bit for bit against one device, a launch a shard, the mesh's
   bytes accounted (_mesh_same).  For
   each solver: the host clock of a dispatch, and over one dispatch under
   the profiler its device time and number of device kernels and copies,
   one device record for each one queued (so in every profiled window of
   this script: _every_record);
2d. the device forms this port runs as plain PyTorch beside those, on the
   card against their oracles: region_stats against region_stats_host in
   f64 (mx exact, ave and dev within 1e-6) at 256 and 65,536 regions;
   bottleneck_all_sources against its numpy oracle, exactly, at
   [64, 64, 64] in f32 and f64, and its row 0 against the bottleneck
   kernel's positive form; the sparse and the dense similarity forms (the
   dense one through a forced overflow of the sparse one) against the host
   form, pair lists equal, at 64, 200, 1024 and 4096 bundles; the wave
   step (parallel/mesh.py) against its numpy oracle on example_batch at
   B=64, V=64, S=16, P_=128, Ns=10, J=64 and on tensors captured from the
   two-sample simulated cohort (seeds 41, 42), exact on bottleneck, mx,
   sim and support, within 1e-6 on ave and dev.  Each with the host clock,
   device time and device kernels of a dispatch, as in 2c;
2e. the policy's measurements (ops/crossover.py, ops/mfu.py): the drain's
   crossover at 64, 256 and 1024 graphs against the native host drain,
   the ladder's against the native host ladder, similarity's and
   coverage's, and the roofline accounting, each printed as one JSON line
   with the card beside it.  The device results must agree with the
   host's; nothing is required of who wins.  The launch counts are reset
   before and read after: the measurements must have launched the drain,
   bottleneck, ladder and bridge kernels;
3. main path: the production cohort (2000 genes x 10 paired-end samples,
   tools/refbuild/baseline.py) through python -m aletsch_tpu with the
   device off (the reference bytes) and through the port's CLI with the
   drain forced onto the card at --max_num_exons 8.  Both CLIs run as
   subprocesses, reference / port, for comparable walls; then the port
   runs once more as a subprocess with --jax_profile_dir (its launch
   counts start at 0 in the new process and are read from its device
   stats line at its end).  Every output file of every port run must be
   byte-identical to the reference's, and the kernel must have carried
   the drain.  The traced run's largest device records are printed, and
   its trace must hold one drain kernel record a launch and one device
   record for each kernel and copy queued; its device time and idle share
   (over the capture and over the subprocess's wall) are printed beside
   the counts;
3b. step path: the port's CLI with ALETSCH_DEVICE_GREEDY=step (one
   bottleneck launch per extraction instead of the drain) on the 200-gene
   cohort of phases 3b to 3h (built, with its reference bytes, after phase
   3's runs), traced as phase 3's; every output file byte-identical to the
   reference's, and the bottleneck kernel must have carried every
   dispatch, with one kernel record a launch in the trace;
3c. the bridge, support and ladder stages on the card (--device_bridge on
   --device_support on --device_ladder on beside the forced drain): in
   this process with every count reset, on the production cohort in trust
   mode, and on the 200-gene cohort in verify mode (ALETSCH_FUSED_TRUST=0:
   the host ladder and drain are authoritative and every device decision
   is compared with the host's; phase 3i holds verify mode at scale).
   Every output file byte-identical to the reference's, every stage
   engaged, ladder_agree == ladder_total and fused_agree == fused_total,
   the drain kernel launched on this path too, and the ladder and bridge
   kernels launched once a dispatch of their solvers, with their summed
   CUDA-event times (launch to completion: the card's wait for each
   launch is in them).  In the verify run the bridge's dispatches are
   watched (_BridgeRows): histograms of its instances' live lengths and
   valid candidates a step (the watcher's own seconds logged), and the
   staged rows of its first 64 dispatches, on which the kernel is then
   held to the plain form, timed back to back (its device time), and
   profiled.  The ladder's solve() clock is projected from phase 2c's
   dispatch first;
3d. the CLI's defaults, where every device stage is on 'auto': the
   production cohort through python -m aletsch_tpu_torch with no
   --device_* flag, once as it is (its waves hold fewer groups than
   device_min_groups, so no stage may ask the policy: no calibration file
   may appear in the run's own temporary directory, and nothing may reach
   the card) and once with ALETSCH_DEVICE=0; then the 200-gene cohort at
   the defaults with --device_min_groups 0, where the first 'auto'
   question measures the calibration; every output byte-identical to the
   reference's; the walls, the calibration's time, and for each stage its
   fit, what 'auto' answered and what it sent to the card.  Every answer
   must equal what the stage's own fit says, and no stage may reach the
   card whose fit loses.  Then --device_similarity on in this process on
   the 200-gene cohort with every subset of two or more bundles sent to
   the card (the production cohort's subsets stay below the 48 bundles
   from which the device forms run): byte-identical, and the sparse
   form's counter must have grown;
3e. scoring on the card: python -m aletsch_tpu_torch.scoring.score and
   python -m aletsch_tpu.scoring.score (jax unimportable, so its forest
   runs _predict_numpy) on the feature CSVs of phase 3's port run with
   tests/fixtures/rf_model_50f.npz: the scores CSV byte-identical, and
   the port's forest counter must show the rows went to the card.  Then
   in this process predict_proba against _predict_numpy, bit for bit, on
   the fixture forest and on a seeded synthetic forest at the trainer's
   defaults (100 trees, max_depth 20), at 256, 4,096 and 65,536 rows of
   50 features: for each, the host clock of a call, its device time and
   device kernels (profiler), and _predict_numpy's time;
3f. the 200-gene cohort through python -m aletsch_tpu_torch --jobs 2
   with the drain forced (the other stages off), jax and aletsch_tpu
   unimportable in every process (a sitecustomize on the workers'
   PYTHONPATH, which also prints each process's launch counts at exit):
   every output byte-identical, and each shard worker must have launched
   the drain kernel; then a --shard 0 2 / --shard 1 2 / --merge_shards
   round, byte-identical;
3g. the device trace: the forced drain on the 200-gene cohort through
   python -m aletsch_tpu_torch --jax_profile_dir: the bytes unchanged, one
   *.pt.trace.json, and in it exactly one drain kernel record a launch
   and a device record for every kernel and copy queued (with --phases
   only: the whole script holds phase 3's traced CLI run to the same);
3h. the process group and the mesh: python -m aletsch_tpu_torch
   --jax_dist_launch 2 on the 200-gene cohort with the drain forced (two
   gloo ranks sharing the card; jax and aletsch_tpu unimportable, each
   rank prints its launches at exit): every output byte-identical, and
   each rank must have launched the drain; dryrun_multichip over this
   machine's cards (the sharded step on real wave tensors against the
   one-device step and the host oracle, then the pipeline with every
   device stage on against the host path); the sharded step over 2, 4
   and 8 shards all placed on cuda:0 -- an emulation of a mesh on one
   card, so labelled -- against the one-device step and the host oracle
   (exact on bottleneck, mx, sim, support; 1e-6 on ave, dev) with its host
   clock; measure_scaling_shape([1]) as one JSON line with the card;
3i. the protocols: (a) the eight golden cohorts of
   tools/refbuild/compare.py (built in a subprocess), each in this process
   with the drain, bridge, support and ladder forced on the card at the
   default --max_num_exons and ALETSCH_REF_QUIRKS=1: the sorted meta GTF
   equal to the upstream binary's (tests/fixtures/goldens), one kernel
   launch a dispatch for every solver, no bridge instance on the
   single-end cohorts; (b) config 4: 2000 genes x
   10 alternating PacBio CCS and ONT samples of full-length single-end
   reads (aletsch_tpu_torch/cohorts.py), with the drain at --max_num_exons
   8, the bridge, support and ladder forced, in trust and in verify mode,
   against python -m aletsch_tpu --device_greedy off: byte-identical,
   every drain and ladder decision agreeing, no bridge instance, the drain
   kernel launched; (c) config 5: 64 smart-seq cells x 1000 genes, forced
   as config 4 in trust mode, each staged support row held to the
   export's gate and the groups counted by sample slots, then at the
   CLI's defaults in a temporary directory of its own beside
   ALETSCH_DEVICE=0: byte-identical, and what 'auto' asked and answered
   for each stage, whether a calibration file appeared and its seconds.
   Every run prints its wall beside the reference's and, for each stage,
   what the card carried, its dispatches, kernel launches, host
   refusals, solve() time and kernel-event time;
3j. the port's benchmark: bench_torch.py --config 3 --mode all --genes
   200 --reps 1 as a subprocess, in a temporary directory of its own: it
   must exit 0 with a compact JSON last line saying correct true, the
   drain, bridge and ladder kernels launched once a dispatch, its traced
   run's device records equal to the kernels, copies and memsets queued,
   an idle share in [0, 1], and the card's name and power limit as
   nvidia-smi gives them.

The last lines are the card (nvidia-smi), one JSON line of the kernels
and the JSON result line.  In the kernels line, "launches" counts each
kernel's launches on its own path (drain: phase 3; the bottleneck's NEG
form: phase 3b; its positive form: bottleneck_from_source in phase 2b;
the ladder and the bridge: phase 3c's trust-mode run), "ms" is the
kernel's device time at that path's shape (one live graph for the drain
and the NEG form, as most dispatches carry one; 64 graphs for the
positive form; 3 for the ladder, whose dispatches carry 2.7 on average;
37 instances of the random batch for the bridge, whose dispatches carry
36.5 on average), "plain_ms" the plain
version's call time on the card at that shape, and "bound_ms" the least
time the card could take for that call: the larger of its bytes over
3.35 TB/s (each output written once and each input read once, of W and P
only the entries that can count: u < v <= sink of an active graph for
the drain, u < v for the bottleneck) and its operations over the card's
rate for them (min/max/compare/select; for the ladder the two f64 adds an
edge slot of each event's ordered in- and out-sums; for the bridge each
valid candidate's S insert compares and the m - 1 compares of selecting
the best of m), counted from this run's sinks, path counts, event counts
and entry counts.  "library_ms" is null: no single PyTorch call computes
a max-min chain in topological order with the drain's tie rule, nor the
ladder's event machine, nor a stable top-K over six keys in one step of
a DP whose next step reads it.  With --kernels-only the
script stops after phase 2e, prints no result line and exits 0: a short
first check of a changed kernel, and a way to time two checkouts in turns
on one card.  --phases runs phase 1 and then only the phases named (of
3e, 3f, 3g, 3h, 3i and 3j): 3i and 3j on their own cohorts, the others on
the 200-gene cohort, with one reference and one forced port run to feed
them; it prints no result line: a short check of those phases.  This
script imports only the port; the JAX package runs as a subprocess.
jax and aletsch_tpu are made unimportable first: the port never uses
either.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

sys.modules["jax"] = None
sys.modules["aletsch_tpu"] = None
# The profiler keeps one CUPTI for the whole process by default, and after
# tens of seconds of other work (phase 2c's plain forms on the host CPU)
# it places some or all of a later capture's device records outside the
# capture's window and drops them (PERF.md; the card's host has no
# constant TSC, the clock of the profiler's timestamps, phase 1 logs its
# flags).  TEARDOWN_CUPTI=1 releases CUPTI at the end of each capture, so
# each of this process's captures, all of work on its main thread, starts
# on a fresh one (and _capture pads it).  A capture with
# profile_all_threads, or of work on other threads, records nothing after
# such a release: the CLI runs that are traced (phases 3, 3b, 3g) are
# subprocesses, each with its one capture, as a user runs them.
os.environ.setdefault("TEARDOWN_CUPTI", "1")

REPO = os.path.dirname(os.path.abspath(__file__))
GENES, SAMPLES = 2000, 10
HOST_ARGS = ["--device_greedy", "off", "--max_num_exons", "8",
             "--verbose", "0"]
# the forced drain alone: the other stages default to 'auto', which would
# ask the measured policy; a later flag of the same name overrides these
DEVICE_ARGS = ["--device_greedy", "on", "--device_min_vertices", "2",
               "--device_min_groups", "0", "--max_num_exons", "8",
               "--verbose", "0", "--device_bridge", "off",
               "--device_support", "off", "--device_ladder", "off",
               "--device_similarity", "off"]
# phase 3d: the CLI's defaults, every device stage on 'auto'; verbose 1
# prints the device stats line the phase reads
DEFAULT_ARGS = ["--max_num_exons", "8", "--verbose", "1"]
BRIDGE_ARGS = ["--device_bridge", "on"]
BRIDGE_SUPPORT_ARGS = BRIDGE_ARGS + ["--device_support", "on"]
LADDER_ARGS = ["--device_ladder", "on"]
# Phase 3c's projection of the ladder's solve() clock on a cohort: its
# dispatches a gene (731 on the 200-gene cohort with the flags above, a
# count of the data, the same on any device) times a dispatch's host clock
# in phase 2c
LADDER_DISPATCHES_PER_GENE = 731 / 200
SMALL_GENES = 200       # the cohort of phases 3b to 3h
SPIN_CYCLES = 10_000_000        # ~5 ms of GPU clock: longer than any enqueue
REPS = 25
# Published peaks of one H100 SXM at its full power limit.  The 67 TFLOP/s
# of f32 outside the tensor cores counts a fused multiply-add as two, so a
# min, max, compare or select goes at half of it; f64 at half of that again
# (the data sheet's 34 TFLOP/s of f64, likewise counted).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
F64_OPS_PER_S = F32_OPS_PER_S / 2


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print("[chip_smoke] %s" % msg, flush=True)


def _reset_launches():
    """Set every kernel wrapper's launch count to 0."""
    from aletsch_tpu_torch.ops import (bottleneck, bridge_topk, drain,
                                       ladder_kernel)
    drain.drain_cuda.launches = 0
    bottleneck.bottleneck_cuda.launches = 0
    ladder_kernel.ladder_cuda.launches = 0
    bridge_topk.bridge_cuda.launches = 0


def _launches():
    """{kernel: launches since the last reset}."""
    from aletsch_tpu_torch.ops import (bottleneck, bridge_topk, drain,
                                       ladder_kernel)
    return {"drain": drain.drain_cuda.launches,
            "bottleneck": bottleneck.bottleneck_cuda.launches,
            "ladder": ladder_kernel.ladder_cuda.launches,
            "bridge": bridge_topk.bridge_cuda.launches}


# ------------------------------------------------------------ phase 1
def environment():
    import torch

    from aletsch_tpu_torch.meta import device_wave
    from aletsch_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log("card: %s | torch.cuda: %s | torch %s, CUDA %s"
        % (smi, name, torch.__version__, torch.version.cuda))
    with open("/proc/cpuinfo") as fh:
        flags = next((ln.split(":", 1)[1].split() for ln in fh
                      if ln.startswith("flags")), [])
    log("host CPU's TSC flags (the profiler's host clock): %s"
        % " ".join(sorted(f for f in flags if "tsc" in f)))
    # the JAX package's CLI (the reference runs below) loads
    # native/libabam.so and makes it on first use: make it here, beside
    # the kernels and the port's own build of the same sources
    t0 = time.perf_counter()
    ref_make = subprocess.Popen(["make", "-s", "-C",
                                 os.path.join(REPO, "native")],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    path, secs = _build.build()
    log("kernel library %s (nvcc %.1f s)"
        % (os.path.relpath(path, REPO), secs))
    entry = "?"
    for line in _build.ptxas_report().splitlines():
        # "Compiling entry function '<mangled name>'", then its spills,
        # then its registers and shared memory
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                      r"(?:I(\w+?)EE)?", line)
        if m:
            entry = m.group(1) + ("<%s>" % m.group(2) if m.group(2) else "")
        elif "spill" in line or "Used" in line:
            log("ptxas %s: %s" % (entry, line.split(":", 1)[-1].strip()))
    _one_runtime(path)
    device_wave.require_native()
    _, err = ref_make.communicate(timeout=600)
    require(ref_make.returncode == 0, "make -C native failed: %s"
            % err[-2000:])
    log("native core ready: the port's build and native/libabam.so (%.1f s "
        "with the kernels)" % (time.perf_counter() - t0))
    return smi, name


def _one_runtime(path):
    """The kernel library takes the CUDA runtime torch has loaded: ldd
    names libcudart.so for it, the process maps one libcudart, and the
    library's cudaRuntimeGetVersion (found through its dependency) reports
    what that one does."""
    import ctypes

    from aletsch_tpu_torch.ops import _build
    lib = _build.load_library()
    ldd = [ln.strip() for ln in subprocess.run(
        ["ldd", path], capture_output=True, text=True, timeout=60,
        check=True).stdout.splitlines() if "libcudart" in ln]
    with open("/proc/self/maps") as fh:
        maps = sorted({f[-1] for f in (ln.split() for ln in fh)
                       if len(f) == 6 and "libcudart" in
                       os.path.basename(f[-1])})
    require(len(ldd) == 1 and len(maps) == 1, "the kernel library's runtime "
            "(ldd: %s) and the process's (%s) are not one libcudart"
            % (ldd, maps))
    ver = {}
    for who, dll in (("the kernel library's", lib),
                     ("torch's", ctypes.CDLL(maps[0]))):
        v = ctypes.c_int(0)
        require(dll.cudaRuntimeGetVersion(ctypes.byref(v)) == 0,
                "cudaRuntimeGetVersion failed")
        ver[who] = v.value
    require(len(set(ver.values())) == 1, "CUDA runtime versions %s" % ver)
    log("kernel library's CUDA runtime: %s; one libcudart in the process "
        "(%s); version %s" % (ldd[0], maps[0], ver))


# ------------------------------------------------------------ phase 2
def _bits(ws):
    import numpy as np
    return ws.view(np.int64 if ws.dtype == np.float64 else np.int32)


def _same(tag, a, b):
    import numpy as np
    pa, wa, na = a
    pb, wb, nb = b
    require(np.array_equal(na, nb), "%s: npaths differ" % tag)
    require(np.array_equal(pa.astype(bool), pb.astype(bool)),
            "%s: paths differ" % tag)
    diff = float(np.abs(wa.astype(np.float64)
                        - wb.astype(np.float64)).max(initial=0.0))
    require(wa.dtype == wb.dtype and np.array_equal(_bits(wa), _bits(wb)),
            "%s: ws differ in bits (max |diff| %g)" % (tag, diff))
    return diff


def _check_batch(tag, batch, maxp, dev):
    """Kernel == plain on the card == plain on the host CPU (f64); kernel
    == plain on the card (f32).  Returns the largest |ws difference|
    seen (0.0 when exact)."""
    import torch

    from aletsch_tpu_torch.ops import drain as D
    from aletsch_tpu_torch.ops.greedy_fused import batch_from_numpy
    host = [t.numpy() for t in D.drain_torch(
        *batch_from_numpy(*batch, torch.device("cpu")), maxp)]
    args = batch_from_numpy(*batch, dev)
    err = 0.0
    for dt in (torch.float64, torch.float32):
        a = (args[0].to(dt), args[1], args[2], args[3].to(dt))
        k = D.drain_cuda(*a, maxp)
        torch.cuda.synchronize()
        p = D.drain_torch(*a, maxp)
        torch.cuda.synchronize()
        k = [t.cpu().numpy() for t in k]
        p = [t.cpu().numpy() for t in p]
        err = max(err, _same("%s %s kernel vs plain" % (tag, dt), k, p))
        if dt == torch.float64:
            err = max(err, _same("%s kernel vs plain on the host CPU" % tag,
                                 k, host))
    return err


def _bound(nbytes, ops, ops_per_s):
    """(bound in ms, what bounds it, the bytes counted): the larger of the
    call's bytes over the card's memory rate and its operations over the
    card's rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _drain_bound(args, out):
    """Roofline bound of one drain call on these inputs, counting what
    this run's sinks need.  Bytes: of W and P only the entries the drain
    can use, those with u < v <= sink of each active graph (sink > 0),
    s (s + 1) / 2 of them; sink, scal and every output in full.
    Operations: for every active graph one forward sweep a recorded path
    plus the one that stops it, a sweep being one min, one compare and one
    select for each of those entries."""
    import torch
    W, P, sink, scal = args
    paths, _, npaths = out
    s = sink.to(torch.int64).cpu()
    pairs = (s > 0) * (s * (s + 1) // 2)
    nbytes = (int(pairs.sum()) * (W.element_size() + P.element_size())
              + _nbytes(sink, scal, *out))
    sweeps = torch.clamp(npaths.to(torch.int64).cpu() + 1, max=paths.shape[1])
    ops = int((sweeps * pairs * 3).sum())
    rate = F64_OPS_PER_S if W.dtype == torch.float64 else F32_OPS_PER_S
    return _bound(nbytes, ops, rate)


def _bottleneck_bound(W, T):
    """Roofline bound of one bottleneck call: of W the V (V - 1) / 2
    entries with u < v of each graph in (no other entry can change T), T
    out, and one min and one max for each of those entries."""
    B, V, _ = W.shape
    pairs = B * (V * (V - 1) // 2)
    return _bound(pairs * W.element_size() + _nbytes(T), pairs * 2,
                  F32_OPS_PER_S)


def _call_ms(fn):
    """Median CUDA-event time of fn() on an idle stream: the host's work
    in the call (checks, allocation, launch) is inside the window."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _device_ms(fn):
    """Median device time of the kernels fn() launches: the stream first
    spins for ~5 ms, so the host has queued the start event, the launch
    and the end event before the card reaches them.  Checked: the start
    event must still be pending when the end event is queued."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
        require(not e0.query(), "the spin ended before the launch was "
                "queued: the device time would include the host's")
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# the profiler's name of each kernel's device records, by _launches() key
KERNEL_EVENT = {"drain": "drain_kernel", "bottleneck": "bottleneck_kernel",
                "ladder": "ladder_kernel", "bridge": "bridge_kernel"}
# A kernel's profiler record and its CUDA-event time (_device_ms) differ by
# the gap the pair of events adds around the launch on the card, 0.0039 to
# 0.0041 ms for every kernel and row count on an H100 80GB HBM3 at 700 W
# (PERF.md), and by the spread of a kernel's time between calls, at most
# 1.1 % in PR 11's runs (the bridge on the cohort's rows, 0.0100 against
# 0.0101 ms): so 0 <= events - profiler <= EVENT_GAP_MS, each side widened
# by EVENT_SPREAD of the events' time.
EVENT_GAP_MS = 0.006
EVENT_SPREAD = 0.02


# host time kept busy inside each capture of this process before its
# first device work and after its last: the profiler's placement of device
# records drifts from the host's clock on the card's host (its CPUs have
# no constant TSC), and a record placed a little outside the capture's
# window is dropped; busy, not asleep, so that the host's clock keeps its
# rate inside the capture
CAPTURE_PAD_S = 0.1


def _busy(seconds):
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


@contextmanager
def _capture(cpu=False):
    """A torch.profiler capture of the card (and of the host with cpu)
    around the with-block, which runs between two CAPTURE_PAD_S of busy
    host time; the card is synchronised before the second."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        _busy(CAPTURE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        _busy(CAPTURE_PAD_S)


def _trace_events(prof):
    """The chrome-trace events of a finished torch.profiler run."""
    from aletsch_tpu_torch.utils import tracing
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return tracing.read_trace(path)
    finally:
        os.unlink(path)


def _every_record(tag, events):
    """The device records of a trace, required to be one for each kernel,
    copy and memset the host queued in its window, and at least one.
    Returns device_counts(events)."""
    from aletsch_tpu_torch.utils import tracing
    c = tracing.device_counts(events)
    n = sum(c[k] for k in tracing.DEVICE_CATS)
    require(n == c["enqueued"] > 0, "%s: the trace holds %d device records "
            "(%d kernels, %d copies, %d memsets) for %d kernels, copies and "
            "memsets queued" % (tag, n, c["kernel"], c["gpu_memcpy"],
                                c["gpu_memset"], c["enqueued"]))
    return c


def _device_us(events, name=""):
    """(count, summed us) of the device records whose name holds `name`
    (every device record with the default)."""
    from aletsch_tpu_torch.utils import tracing
    recs = [e for e in events if e.get("cat") in tracing.DEVICE_CATS
            and name in e.get("name", "")]
    return len(recs), sum(float(e.get("dur", 0.0)) for e in recs)


def _profiled_ms(fn, kernel):
    """Mean device time of a kernel (a _launches() key) over REPS calls of
    fn(), as the profiler (CUPTI) records it: one record a launch, and one
    for every kernel and copy queued, or the check fails."""
    import torch
    fn()
    torch.cuda.synchronize()
    n0 = _launches()[kernel]
    with _capture() as prof:
        for _ in range(REPS):
            fn()
    launches = _launches()[kernel] - n0
    events = _trace_events(prof)
    _every_record("%s kernel, %d calls profiled" % (kernel, REPS), events)
    n, us = _device_us(events, KERNEL_EVENT[kernel])
    require(n == launches == REPS, "%s kernel: the profiler recorded %d "
            "records for %d launches" % (kernel, n, launches))
    return us / n / 1000.0


def _agree(tag, t):
    """The kernel's profiler time against its CUDA-event time: within the
    event pair's gap and the spread (EVENT_GAP_MS, EVENT_SPREAD)."""
    d = t["device"] - t["profiler"]
    slack = EVENT_SPREAD * t["device"]
    require(-slack <= d <= EVENT_GAP_MS + slack, "%s: the profiler's %.4f ms "
            "and the CUDA events' %.4f ms differ by more than the event "
            "gap (%.3f ms) and %.0f %%" % (tag, t["profiler"], t["device"],
                                          EVENT_GAP_MS, 100 * EVENT_SPREAD))
    return d


def kernel_vs_plain(dev):
    import numpy as np

    from aletsch_tpu_torch.ops import drain as D
    from aletsch_tpu_torch.ops.greedy_fused import batch_from_numpy
    B = V = MAXP = 64
    rng = np.random.default_rng(2024)
    cases = [("fuzz%d" % i, D.fuzz_batch(rng, B, V)) for i in range(4)]
    cases += [("full%d" % i, D.fuzz_batch(rng, B, V, n_vertices=V))
              for i in range(4)]
    ties = [D.fuzz_ties(rng, B, v) for v in (V, V, 33)]
    cases += [("ties%d V=%d" % (i, t[0].shape[1]), t)
              for i, t in enumerate(ties)]
    W, _, sink, _ = ties[0]
    col = W[np.arange(B), :, sink]
    tied = int((((col == col.max(axis=1, keepdims=True)) & (col > 0))
                .sum(axis=1) > 1).sum())
    require(tied > 0 and ((sink > 0) & (sink < 32)).any()
            and (sink > 32).any() and (sink == 0).any(),
            "the tie batches miss a hard case")
    log("tie batches: %d of %d sinks have equal heaviest in-edges that "
        "differ in P; sinks from %d to %d" % (tied, B, sink[sink > 0].min(),
                                              sink.max()))
    err = 0.0
    for tag, batch in cases:
        err = max(err, _check_batch(tag, batch, MAXP, dev))
    # edge cases: inactive rows, one row, the MAXP cap
    W, P, sink, scal = D.fuzz_batch(rng, B, V)
    sink_off = sink.copy()
    sink_off[::2] = 0
    err = max(err, _check_batch("inactive", (W, P, sink_off, scal), MAXP,
                                dev))
    err = max(err, _check_batch("nrows=1", (W[:1], P[:1], sink[:1],
                                            scal[:1]), MAXP, dev))
    err = max(err, _check_batch("maxp=2", (W, P, sink, scal), 2, dev))
    # nrows = 0: nothing to launch
    n0 = D.drain_cuda.launches
    e = batch_from_numpy(W[:0], P[:0], sink[:0], scal[:0], dev)
    out = D.drain_cuda(*e, MAXP)
    require(D.drain_cuda.launches == n0, "nrows=0 launched a kernel")
    require(tuple(out[0].shape) == (0, MAXP, V), "nrows=0 shape")
    log("kernel == plain on the card == plain on the host CPU, bit for bit "
        "on %d batches and the edge cases (max |ws diff| %g)"
        % (len(cases), err))

    times = {}
    Wb, Pb, sb, cb = batch_from_numpy(
        *D.fuzz_batch(np.random.default_rng(3), B, V), dev)
    for n in (1, 2, 64):
        a = (Wb[:n], Pb[:n], sb[:n], cb[:n])
        t = {"device": _device_ms(lambda: D.drain_cuda(*a, MAXP)),
             "profiler": _profiled_ms(lambda: D.drain_cuda(*a, MAXP),
                                      "drain"),
             "call": _call_ms(lambda: D.drain_cuda(*a, MAXP)),
             "plain": _call_ms(lambda: D.drain_torch(*a, MAXP))}
        t["bound"], t["bound_by"], t["bytes"] = _drain_bound(
            a, D.drain_cuda(*a, MAXP))
        times[n] = t
        log("drain f64 nrows=%d: kernel device %.4f ms (events, launch "
            "cost outside), profiler %.4f ms (%d records for %d launches; "
            "events - profiler %.4f ms); wrapper call %.4f ms; plain "
            "call %.4f ms (medians of %d); bound %.7f ms (%s; %d bytes needed "
            "at sinks %s), share of it reached %.3f %%"
            % (n, t["device"], t["profiler"], REPS, REPS,
               _agree("drain nrows=%d" % n, t), t["call"], t["plain"], REPS,
               t["bound"], t["bound_by"], t["bytes"],
               "%d to %d" % (int(a[2].min()), int(a[2].max())),
               100.0 * t["bound"] / t["device"]))
    return err, times


# ------------------------------------------------------------ phase 2b
def _canon(T):
    """int32 view with -0.0 turned into +0.0: min/max over {-0.0, +0.0}
    may return either zero, and the native consumer reads values only."""
    import numpy as np
    return (np.asarray(T, dtype=np.float32) + np.float32(0.0)).view(np.int32)


def _check_tables(tag, W, dev):
    """Kernel == plain on the card == plain on the host CPU, in both
    forms, bit for bit up to the sign of a zero, and
    bottleneck_from_source(version=1 and 2) == the positive form.  Returns
    the largest |kernel - plain| seen (0.0 when exact)."""
    import numpy as np
    import torch

    from aletsch_tpu_torch.ops import bottleneck as BN
    Wd = torch.from_numpy(W).to(dev)
    err = 0.0
    for neg_form in (True, False):
        form = "NEG" if neg_form else "positive"
        host = BN.bottleneck_torch(torch.from_numpy(W), neg_form).numpy()
        k = BN.bottleneck_cuda(Wd, neg_form)
        torch.cuda.synchronize()
        p = BN.bottleneck_torch(Wd, neg_form)
        torch.cuda.synchronize()
        k, p = k.cpu().numpy(), p.cpu().numpy()
        require(k.shape == p.shape == host.shape == W.shape[:2],
                "%s %s form: shapes %s %s %s" % (tag, form, k.shape, p.shape,
                                                 host.shape))
        require(np.array_equal(_canon(k), _canon(p)),
                "%s %s form: kernel vs plain on the card differ" % (tag, form))
        require(np.array_equal(_canon(k), _canon(host)),
                "%s %s form: kernel vs plain on the host CPU differ"
                % (tag, form))
        err = max(err, float(np.abs(k.astype(np.float64)
                                    - p.astype(np.float64)).max(initial=0.0)))
        if not neg_form:
            for version in (1, 2):
                T = BN.bottleneck_from_source(W, version=version, device=dev)
                require(T.dtype == np.float32
                        and np.array_equal(_canon(T), _canon(host)),
                        "%s: bottleneck_from_source(version=%d) vs plain on "
                        "the host CPU differ" % (tag, version))
    return err


def bottleneck_vs_plain(dev):
    """Phase 2b.  Returns (max error, launches of the positive form on its
    own path, {(form, nrows): times})."""
    import numpy as np
    import torch

    from aletsch_tpu_torch.ops import bottleneck as BN
    from aletsch_tpu_torch.ops.drain import fuzz_tables
    rng = np.random.default_rng(77)
    err, n_batches, zeros = 0.0, 0, [0, 0]
    for V in (16, 33, 64):
        for i in range(4):
            # the last batch of each V carries entries on and below the
            # diagonal, which the DP must ignore
            W = fuzz_tables(rng, 64, V, back_edges=(i == 3))
            zeros[0] += int(((W == 0) & ~np.signbit(W)).sum())
            zeros[1] += int(((W == 0) & np.signbit(W)).sum())
            err = max(err, _check_tables("V=%d fuzz%d" % (V, i), W, dev))
            if i == 3:
                low = np.tril(np.ones((V, V), dtype=bool))[None]
                require(((W > BN.NEG) & low).any(), "no back edges drawn")
                same = BN.bottleneck_cuda(torch.from_numpy(
                    np.where(low, np.float32(BN.NEG), W)).to(dev), True)
                back = BN.bottleneck_cuda(torch.from_numpy(W).to(dev), True)
                require(np.array_equal(_canon(same.cpu().numpy()),
                                       _canon(back.cpu().numpy())),
                        "V=%d: entries on or below the diagonal changed T"
                        % V)
            n_batches += 1
    require(zeros[0] > 0 and zeros[1] > 0, "no 0.0 / -0.0 edges drawn")
    # edge cases: one row, an all-NEG row, the full batch
    W = fuzz_tables(rng, 64, 64)
    err = max(err, _check_tables("nrows=1", W[:1], dev))
    Wn = W.copy()
    Wn[5] = np.float32(BN.NEG)
    err = max(err, _check_tables("all-NEG row", Wn, dev))
    err = max(err, _check_tables("B=64", W, dev))
    # nrows = 0: nothing to launch
    n0 = BN.bottleneck_cuda.launches
    out = BN.bottleneck_cuda(torch.from_numpy(W[:0]).to(dev), True)
    require(BN.bottleneck_cuda.launches == n0, "nrows=0 launched a kernel")
    require(tuple(out.shape) == (0, 64), "nrows=0 shape %s" % (out.shape,))
    log("bottleneck kernel == plain on the card == plain on the host CPU, "
        "both forms, bit for bit with signed zeros canonicalised, on %d "
        "batches (%d 0.0 and %d -0.0 edges) and the edge cases "
        "(max |diff| %g)" % (n_batches, zeros[0], zeros[1], err))

    # the positive form's own path: bottleneck_from_source, counts reset
    Wp = fuzz_tables(np.random.default_rng(8), 64, 64)
    want = _canon(BN.bottleneck_torch(torch.from_numpy(Wp), False).numpy())
    _reset_launches()
    got = [BN.bottleneck_from_source(Wp, version=v, device=dev)
           for v in (1, 2)]
    n = _launches()
    pos_launches = n["bottleneck"]
    require(n == {"drain": 0, "bottleneck": 2, "ladder": 0, "bridge": 0},
            "bottleneck_from_source launched %s" % n)
    for v, T in zip((1, 2), got):
        require(T.dtype == np.float32 and np.array_equal(_canon(T), want),
                "bottleneck_from_source(version=%d) differs from the plain "
                "version on the host CPU" % v)
    log("bottleneck_from_source(version=1) == (version=2) == plain on the "
        "host CPU, [64, 64, 64], %d launches" % pos_launches)

    times = {}
    Wd = torch.from_numpy(fuzz_tables(np.random.default_rng(3), 64,
                                      64)).to(dev)
    for neg_form in (True, False):
        form = "neg" if neg_form else "pos"
        for n in (1, 2, 64):
            a = Wd[:n]
            t = {"device": _device_ms(lambda: BN.bottleneck_cuda(a, neg_form)),
                 "profiler": _profiled_ms(
                     lambda: BN.bottleneck_cuda(a, neg_form), "bottleneck"),
                 "call": _call_ms(lambda: BN.bottleneck_cuda(a, neg_form)),
                 "plain": _call_ms(lambda: BN.bottleneck_torch(a, neg_form))}
            t["bound"], t["bound_by"], t["bytes"] = _bottleneck_bound(
                a, BN.bottleneck_cuda(a, neg_form))
            times[form, n] = t
            log("bottleneck %s form, V=64, nrows=%d: kernel device %.4f ms "
                "(events, launch cost outside), profiler %.4f ms (%d "
                "records for %d launches; events - profiler %.4f ms); "
                "wrapper call %.4f ms; plain call %.4f ms (medians of %d); "
                "bound %.7f ms (%s; %d bytes needed), share of it reached "
                "%.3f %%"
                % (form, n, t["device"], t["profiler"], REPS, REPS,
                   _agree("bottleneck %s nrows=%d" % (form, n), t),
                   t["call"], t["plain"], REPS, t["bound"], t["bound_by"],
                   t["bytes"],
                   100.0 * t["bound"] / t["device"]))
    return err, pos_launches, times


# ------------------------------------------------------------ phase 2c
def _host_ms(fn, reps):
    """Median host clock of fn(), which ends with its results on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dispatch_profile(tag, fn, calls=1):
    """(device ms a call, device records a call, the trace's events) of
    `calls` calls of fn() under the profiler (host and card; each call
    inside the annotation "dispatch"): every kernel and copy queued has its
    device record, and there is one at least."""
    from torch.profiler import record_function
    with _capture(cpu=True) as prof:
        for _ in range(calls):
            with record_function("dispatch"):
                fn()
    events = _trace_events(prof)
    _every_record(tag, events)
    n, us = _device_us(events)
    return us / calls / 1000.0, n / calls, events


def _dispatch_split(events):
    """The traced dispatches of one copy in, one kernel and one copy out,
    by part, ms (medians over the dispatches but the window's first, which
    pays the profiler's own start): on the host, the dispatch's span, its
    runtime calls (the copy in, the launch, the copy out, the wait for the
    card, the others: events, attributes) and its own work outside them;
    on the card, the copy in, the gap to the kernel, the kernel, the gap to
    the copy out and the copy out, each record found by its call's
    correlation id.  The host's and the card's clocks are not compared."""
    from aletsch_tpu_torch.utils import tracing

    def ts(e):
        return float(e["ts"])

    def end(e):
        return ts(e) + float(e.get("dur", 0.0))

    def corr(e):
        return e.get("args", {}).get("correlation")

    card = {corr(e): e for e in events if e.get("cat") in tracing.DEVICE_CATS}
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "dispatch"), key=ts)
    parts = []
    for span in spans[1:]:
        calls = sorted((e for e in events
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")
                        and ts(span) <= ts(e) <= end(span)), key=ts)
        copies = [e for e in calls if e["name"].startswith("cudaMemcpy")]
        launches = [e for e in calls if "LaunchKernel" in e["name"]]
        waits = [e for e in calls if "Synchronize" in e["name"]]
        recs = [card.get(corr(e)) for e in (copies + launches)]
        require(len(copies) == 2 and len(launches) == 1 and None not in recs
                and recs[2].get("cat") == "kernel", "a traced dispatch is "
                "not one copy in, one launch and one copy out")
        cin, cout, kern = recs
        part = {"host": float(span["dur"]),
                "copy in call": float(copies[0]["dur"]),
                "launch call": float(launches[0]["dur"]),
                "copy out call": float(copies[1]["dur"]),
                "wait": sum(float(e["dur"]) for e in waits),
                "other calls": sum(float(e["dur"]) for e in calls
                                   if e not in copies + launches + waits)}
        part["host work"] = part["host"] - sum(
            v for k, v in part.items() if k != "host")
        part.update({"copy in": float(cin["dur"]),
                     "gap in": ts(kern) - end(cin),
                     "kernel": float(kern["dur"]),
                     "gap out": ts(cout) - end(kern),
                     "copy out": float(cout["dur"])})
        parts.append(part)
    require(parts, "no traced dispatch to split")
    return {k: statistics.median(p[k] for p in parts) / 1000.0
            for k in parts[0]}


# calls of a solver in its profiled window: the first pays the profiler's
# start, the others are split (_dispatch_split)
SPLIT_CALLS = 6


def _form_times(tag, solve, sizes, reps, ops=None):
    """Time one solver's dispatch at each size: host clock, device time and
    device records (kernels and copies), one for each queued; with `ops`
    (a dispatch of one copy in, one kernel and one copy out: 3), exactly
    that many a dispatch in a window of SPLIT_CALLS dispatches, and their
    split (_dispatch_split).  Returns {n: {...}}."""
    out = {}
    for n in sizes:
        t = {"host_ms": _host_ms(lambda: solve(n), reps)}
        calls = 1 if ops is None else SPLIT_CALLS
        t["device_ms"], t["kernels"], events = _dispatch_profile(
            "%s nrows=%d" % (tag, n), lambda: solve(n), calls)
        split = ""
        if ops is not None:
            require(t["kernels"] == ops, "%s nrows=%d: %g device records a "
                    "dispatch, not %d" % (tag, n, t["kernels"], ops))
            t["split"] = _dispatch_split(events)
            split = "; traced, medians of %d: %s" % (calls - 1, ", ".join(
                "%s %.4f" % kv for kv in t["split"].items()))
        out[n] = t
        log("%s nrows=%d: host clock %.3f ms a dispatch (median of %d); "
            "device time %.3f ms over %g device kernels and copies a "
            "dispatch, one record for each queued (profiler)%s"
            % (tag, n, t["host_ms"], reps, t["device_ms"], t["kernels"],
               split))
    return out


def _abs_diff(g, w):
    """The largest absolute difference of two equal-shaped arrays: f64 as
    f64 (0 where the bits agree, so equal infinities count 0), the rest
    as integers."""
    import numpy as np
    if not g.size:
        return 0.0
    if g.dtype == np.float64:
        with np.errstate(invalid="ignore", over="ignore"):
            d = np.where(_bits(g) == _bits(w), 0.0, np.abs(g - w))
    else:
        d = np.abs(g.astype(np.int64) - w.astype(np.int64))
    return float(d.max())


def _outputs_same(tag, names, got, want):
    """Every output of two runs (host arrays, in the order of `names`)
    equal bit for bit (f64 on int64 views).  Returns the largest absolute
    difference over them (_abs_diff)."""
    import numpy as np
    err = 0.0
    for name, g, w in zip(names, got, want):
        require(g.dtype == w.dtype and g.shape == w.shape,
                "%s: %s differs in type or shape" % (tag, name))
        err = max(err, _abs_diff(g, w))
        require(np.array_equal(_bits(g) if g.dtype == np.float64 else g,
                               _bits(w) if w.dtype == np.float64 else w),
                "%s: %s differs (max |diff| %g)"
                % (tag, name, _abs_diff(g, w)))
    return err


def _check_ladder(tag, states, refs, shape, dev, rows):
    """The kernel on the card == the plain form on the card == the plain
    form on the host CPU, in every output and the event counts, at each
    row count (the first n states); the kernel's logs == the reference
    machine's decisions.  `refs` may be `states` itself: the states are
    packed before the reference machine consumes them.  Returns (states
    compared with the reference machine, decisions compared, the packed
    arrays, the largest absolute difference of kernel and plain form)."""
    import numpy as np

    from aletsch_tpu_torch.ops import ladder_kernel as LK
    from aletsch_tpu_torch.ops import ladder_ref
    n = len(states)
    arr = LK.pack_states(states, n, shape["V"], shape["E"], shape["H"],
                         shape["L"])
    kw = {"DMAX": shape["DMAX"], "DLOG": shape["DLOG"], "with_events": True}
    names = LK.OUT_NAMES + ("events",)
    on_card = LK.batch_from_numpy(arr, dev)
    host = LK.ladder_plain(*LK.batch_from_numpy(arr, "cpu"), **kw)
    err = 0.0
    for r in rows:
        require(r <= n, "%s ladder: %d states, fewer than %d rows"
                % (tag, n, r))
        sub = [a[:r] for a in on_card]
        kern = [t.cpu().numpy() for t in LK.ladder_cuda(*sub, **kw)]
        plain = [t.cpu().numpy() for t in LK.ladder_plain(*sub, **kw)]
        want = [t[:r].numpy() for t in host]
        err = max(err, _outputs_same(
            "%s ladder, %d rows: the kernel against the plain form on the "
            "host CPU" % (tag, r), names, kern, want))
        err = max(err, _outputs_same(
            "%s ladder, %d rows: the kernel against the plain form on the "
            "card" % (tag, r), names, kern, plain))
        _outputs_same("%s ladder, %d rows: the plain form on the card "
                      "against the host CPU's" % (tag, r), names, plain, want)
    larm, ltgt, ndec, status = (t.numpy() for t in host[:4])
    decisions = compared = 0
    for b, ref in enumerate(refs):
        dec, st = ladder_ref.run_ladder(ref, max_decisions=shape["DLOG"])
        if st != ladder_ref.ST_CLEAN or status[b] != 0:
            # an overflow makes the host redo the whole ladder: the card
            # must report one wherever the reference machine does
            require(status[b] != 0 or st == ladder_ref.ST_CLEAN,
                    "%s ladder: state %d overflows in the reference "
                    "machine only" % (tag, b))
            continue
        got = [(int(larm[b, i]), int(ltgt[b, i]))
               for i in range(int(ndec[b]))]
        require(got == dec, "%s ladder: state %d decides %s, the reference "
                "machine %s" % (tag, b, got[:6], dec[:6]))
        compared += 1
        decisions += len(dec)
    log("%s ladder: csrc/ladder.cu == the plain form on the card == the plain "
        "form on the host CPU, every output and the event counts bit for "
        "bit (max |diff| %g), at %s rows; logs == the reference machine's "
        "on %d of %d states (%d decisions); events a graph %d to %d"
        % (tag, err, " / ".join(str(r) for r in rows), compared, n,
           decisions, int(host[-1].min()), int(host[-1].max())))
    return compared, decisions, arr, err


def _ladder_bound(args, outs):
    """Roofline bound of one ladder call on these inputs: every input read
    and every output written once, and as operations the ordered in- and
    out-sums each event of each graph needs at the least (two f64 adds an
    edge slot), counted from this run's event counts."""
    E = args[0].shape[1]
    ops = int(outs[-1].sum()) * 2 * E
    return _bound(_nbytes(*args, *outs), ops, F64_OPS_PER_S)


def _ptxas_lines(kernel):
    """What ptxas reported for one kernel's entries."""
    from aletsch_tpu_torch.ops import _build
    out, on = [], False
    for line in _build.ptxas_report().splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("spill" in line or "Used" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def _ladder_split(LK, batches):
    """The profiling instance (ladder_profile: clock64() at each barrier of
    the block's loop) at 3 and 64 rows of each batch: its outputs must
    equal the kernel's; logs each pass's cycles an event, overall and by
    the arm that ran (pc)."""
    import numpy as np
    names = LK.OUT_NAMES + ("events",)
    for tag, on_card in batches:
        for n in (3, 64):
            a = [t[:n] for t in on_card]
            outs, cyc, ev = LK.ladder_profile(*a)
            want = [t.cpu().numpy() for t in LK.ladder_cuda(
                *a, with_events=True)]
            _outputs_same("%s ladder, %d rows: the profiling instance "
                          "against the kernel" % (tag, n), names,
                          [t.cpu().numpy() for t in outs], want)
            total = int(ev.sum())
            require(total == int(want[-1].sum()), "%s: the profiling "
                    "instance counted %d events, the kernel %d"
                    % (tag, total, int(want[-1].sum())))
            every = cyc.sum(axis=1)
            log("ladder pass split, %s, %d rows (%d events): cycles an "
                "event %s; all passes %.0f"
                % (tag, n, total, ", ".join(
                    "%s %.0f (%.1f %%)" % (p, c / total, 100.0 * c
                                           / every.sum())
                    for p, c in zip(LK.PROF_PASSES, every)),
                   every.sum() / total))
            for k, pc in enumerate(LK.PROF_PCS):
                if ev[k]:
                    log("  pc %s: %d events, cycles an event %s"
                        % (pc, ev[k], ", ".join(
                            "%s %.0f" % (p, c / ev[k]) for p, c in
                            zip(LK.PROF_PASSES, cyc[:, k]))))
            require(np.all(cyc >= 0), "negative cycle counts")


def ladder_vs_plain(dev):
    """Phase 2c, the ladder: csrc/ladder.cu against its plain form on fuzz
    states at the CPU tests' shape and at the production shape and on the
    ladder fixtures, at 1, 3, 55 and 64 rows; then its times and bound at
    the production shape, and the solver's dispatch.  Returns (the largest
    absolute difference of kernel and plain form over every comparison,
    {nrows: times} of the kernel, {nrows: times} of DeviceLadder.solve)."""
    import numpy as np

    from aletsch_tpu_torch.ops import ladder_kernel as LK
    from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
    rows = (1, 3, 55, 64)
    small = dict(V=24, E=96, H=16, L=16, DMAX=12, DLOG=64)
    full = dict(V=LK.DEFAULT_V, E=LK.DEFAULT_E, H=LK.DEFAULT_H,
                L=LK.DEFAULT_L, DMAX=LK.DEFAULT_DMAX, DLOG=LK.DEFAULT_DLOG)
    shapes = {k: full[k] for k in "VEHL"}
    seen, err = 0, 0.0
    for tag, shape, seeds in (("small-shape", small, range(100)),
                              ("production-shape", full, range(100))):
        refs, states = LK.fuzz_states(seeds, shape["V"], shape["E"],
                                      shape["H"], shape["L"])
        n, _, arr, e = _check_ladder(tag, states, refs, shape, dev, rows)
        seen, err = seen + n, max(err, e)
        if shape is full:
            fuzz = arr
    fixtures = os.path.join(REPO, "tests", "fixtures", "ladder")
    # the first 64 fixtures that fit: the host CPU's plain run costs the
    # same a row as a fuzz state's
    states = LK.fixture_states(fixtures, **shapes)[:64]
    n, _, fix, e = _check_ladder("fixture", states, states, full, dev, rows)
    err = max(err, e)
    require(seen >= 80 and n >= 64, "too few ladder states compared with "
            "the reference machine (%d fuzz, %d fixtures)" % (seen, n))
    log("ptxas ladder_kernel: %s" % "; ".join(_ptxas_lines("ladder_kernel")))

    on_card = LK.batch_from_numpy(fuzz, dev)
    times = {}
    for n in rows:
        a = [t[:n] for t in on_card]
        outs = LK.ladder_cuda(*a, with_events=True)
        t = {"device": _device_ms(lambda: LK.ladder_cuda(*a)),
             "profiler": _profiled_ms(lambda: LK.ladder_cuda(*a),
                                      "ladder"),
             "call": _call_ms(lambda: LK.ladder_cuda(*a)),
             # the plain form at 3 and 64 rows only (the script's time)
             "plain": _host_ms(lambda: [t.cpu() for t in LK.ladder_plain(
                 *a)], 2) if n in (3, 64) else None,
             "events": int(outs[-1].max()), "sum": int(outs[-1].sum())}
        t["bound"], t["bound_by"], t["bytes"] = _ladder_bound(a, outs)
        times[n] = t
        log("ladder kernel nrows=%d (%d events in the longest graph, %d in "
            "all): device %.4f ms (events, launch cost outside), profiler "
            "%.4f ms (%d records for %d launches; events - profiler %.4f "
            "ms); wrapper call %.4f ms; plain form's call %s (host clock, "
            "median of 2); bound %.7f ms (%s; %d bytes), share of it "
            "reached %.4f %%"
            % (n, t["events"], t["sum"], t["device"], t["profiler"], REPS,
               REPS, _agree("ladder nrows=%d" % n, t), t["call"],
               "%.2f ms" % t["plain"] if t["plain"] is not None
               else "not timed", t["bound"], t["bound_by"], t["bytes"],
               100.0 * t["bound"] / t["device"]))
    fix_card = LK.batch_from_numpy(fix, dev)
    for n in rows:
        a = [t[:n] for t in fix_card]
        outs = LK.ladder_cuda(*a, with_events=True)
        t = {"device": _device_ms(lambda: LK.ladder_cuda(*a)),
             "events": int(outs[-1].max()), "sum": int(outs[-1].sum())}
        t["bound"], t["bound_by"], t["bytes"] = _ladder_bound(a, outs)
        times["fixture", n] = t
        log("ladder kernel on the first %d fixtures (%d events in the "
            "longest graph, %d in all): device %.4f ms; bound %.7f ms (%s), "
            "share of it reached %.4f %%"
            % (n, t["events"], t["sum"], t["device"], t["bound"],
               t["bound_by"], 100.0 * t["bound"] / t["device"]))
    _ladder_split(LK, (("production-shape fuzz", on_card),
                       ("fixture", fix_card)))
    # the solver: the staged rows, one launch, the host rows back
    ldev = DeviceLadder(device=dev)
    ldev.stage_states(fuzz, 64)
    want = [t.cpu().numpy() for t in LK.ladder_cuda(
        *(t[:64] for t in on_card))]
    for name, g, w in zip(LK.OUT_NAMES, ldev.solve(64), want):
        require(g.dtype == w.dtype and g.flags["C_CONTIGUOUS"]
                and np.array_equal(g, w), "ladder solve(64): %s "
                "differs from the kernel's" % name)
    n0 = LK.ladder_cuda.launches
    ldev.solve(3)
    require(LK.ladder_cuda.launches == n0 + 1, "a ladder dispatch launched "
            "the kernel %d times" % (LK.ladder_cuda.launches - n0))
    solve = _form_times("ladder solve(), one kernel launch,", ldev.solve,
                        (1, 3, 55, 64), 5, ops=3)

    def staged():
        solver = DeviceLadder(device=dev)
        solver.stage_states(fuzz, 64)
        return solver
    _mesh_same("ladder solve()", staged, (1, 3, 37, 64),
               lambda: LK.ladder_cuda.launches, LK.OUT_NAMES[:4])
    return err, times, solve


def _bridge_bound(args, outs):
    """Roofline bound of one bridge call on these inputs: every input read
    and every output written once, and as operations, for each vertex step
    of each instance with m valid candidates, S compares for each one's
    insert and m - 1 for selecting the best of them (the least a selection
    can do), counted from this run's entry counts (pix >= 0; the source
    holds one entry)."""
    import numpy as np

    from aletsch_tpu_torch.ops.bridge_topk import S
    P = args[0].cpu().numpy()
    n, V, _ = P.shape
    entries = (outs[2].cpu().numpy() >= 0).sum(axis=2)          # [n, V]
    entries[:, 0] = 1
    live = (P >= 0) & (P < V)
    m = (entries[np.arange(n)[:, None, None], np.clip(P, 0, V - 1)]
         * live).sum(axis=2)[:, 1:].astype(np.int64)
    ops = int((S * m + np.maximum(m - 1, 0)).sum())
    return _bound(_nbytes(*args, *outs), ops, F32_OPS_PER_S)


def _bridge_split(BT, tag, on_card):
    """The profiling instance (bridge_profile: lane 0 reads clock64() at
    the warp's sync points) over every row of one batch on the card: its
    outputs must equal the kernel's; logs each pass's cycles, a step with
    candidates (build, select, write), a step without (empty), an instance
    (load, out), and each pass's share.  Returns (cycles by pass,
    counts)."""
    names = ("ostk", "par", "pix")
    n = on_card[0].shape[0]
    outs, cyc, cnt = BT.bridge_profile(*on_card)
    _outputs_same("%s bridge, %d rows: the profiling instance against the "
                  "kernel" % (tag, n), names, [t.cpu().numpy() for t in outs],
                  [t.cpu().numpy() for t in BT.bridge_cuda(*on_card)])
    require(all(c >= 0 for c in cyc.values()), "negative cycle counts")
    total = sum(cyc.values())
    full = max(cnt["steps"] - cnt["empty_steps"], 1)
    per = {"load": n, "out": n, "empty": max(cnt["empty_steps"], 1)}
    log("bridge pass split, %s, %d rows (%d steps run, %d of them with no "
        "valid candidate, %d past the instances' ends not run; %.1f valid "
        "candidates a step with any): cycles %s; all passes %.0f an "
        "instance"
        % (tag, n, cnt["steps"], cnt["empty_steps"], cnt["tail_steps"],
           cnt["candidates"] / full,
           ", ".join("%s %.0f a %s (%.1f %%)"
                     % (p, c / per.get(p, full),
                        "instance" if p in ("load", "out") else "step",
                        100.0 * c / max(total, 1))
                     for p, c in cyc.items()), total / n))
    return cyc, cnt


def _mesh_same(tag, make, rows, launches, solve_names):
    """A solver (make(): staged, on the card) over the mesh emulated as two
    and as three cuda:0 devices (ops/meshing.py's split and replicated
    branches) at each row count == the same solver on one device, bit for
    bit: one kernel launch a shard, the mesh's bytes accounted."""
    import torch

    from aletsch_tpu_torch.ops import meshing
    one = make()
    want = {r: one.solve(r) for r in rows}
    local = meshing._local_devices
    try:
        for n in (2, 3):
            meshing._local_devices = \
                lambda d, n=n: [torch.device("cuda", 0)] * n
            solver = make()
            for r, w in want.items():
                n0 = launches()
                got = solver.solve(r)
                require(launches() == n0 + n, "%s over %d devices, %d rows: "
                        "%d launches" % (tag, n, r, launches() - n0))
                _outputs_same("%s over %d devices, %d rows, against one "
                              "device" % (tag, n, r), solve_names, got, w)
            st = solver.stats
            require(st.get("mesh_devices") == n
                    and st.get("mesh_dispatches") == len(rows)
                    and st.get("mesh_bytes_in", 0) > 0
                    and st.get("mesh_bytes_out") == sum(
                        a.nbytes for w in want.values() for a in w),
                    "%s over %d devices: the mesh's stats %s"
                    % (tag, n, {k: v for k, v in st.items()
                                if k.startswith("mesh")}))
    finally:
        meshing._local_devices = local
    log("%s over the mesh emulated as 2 and 3 cuda:0 devices == one device "
        "bit for bit at %s rows, one launch a shard, mesh bytes accounted"
        % (tag, " / ".join(str(r) for r in rows)))


def _wrap_batch(BT, rng):
    """64 small-shape instances whose lengths near 2^31 make the length sum
    wrap (rows 0-31) and whose weights negate past, onto or around BIG
    (rows 32-63): valid key tuples at or past the absent candidates'."""
    import numpy as np
    P, Wt, Lv, tgt = BT.fuzz_batch(rng, 64, 16, 4, 4)
    Lv[:32] = rng.integers(2**30, 2**31 - 1, size=Lv[:32].shape)
    live = P[32:] >= 0
    Wt[32:] = np.where(live, rng.choice(
        np.array([-2**31, -2**30 - 1, -2**30, -5, 0, 7], np.int32),
        size=Wt[32:].shape), 0)
    return P, Wt, Lv, tgt


def _odd_rows(t):
    """t's rows as a view into a copy whose rows lie one int further apart
    than their data, on t's device."""
    import torch
    n = t.shape[0]
    flat = t.reshape(n, -1)
    wide = torch.zeros((n, flat.shape[1] + 1), dtype=t.dtype,
                       device=t.device)
    wide[:, :-1] = flat
    return wide[:, :-1].unflatten(1, t.shape[1:]) if t.dim() > 2 \
        else wide[:, :-1]


def bridge_vs_plain(dev):
    """Phase 2c, the bridge top-K: csrc/bridge.cu (bridge_cuda) against its
    plain form on the card and on the host CPU, and the host CPU's against
    the numpy oracle, at 1, 3, 37 and 64 rows, on a random and a tie-heavy
    batch at the production shape, a tie-heavy one at the CPU tests' shape
    (passed in rows one int wider than their data), one with 40 in-edge
    slots and one whose lengths and keys wrap int32 (not asked of the
    oracle); then its times and bound on the random batch, and the
    solver's dispatch.  Returns (the largest absolute difference of kernel and plain
    form, {nrows: times} of the kernel, {nrows: times} of
    DeviceBridge.solve)."""
    import numpy as np

    from aletsch_tpu_torch.ops import bridge_topk as BT
    rows, names = (1, 3, 37, 64), ("ostk", "par", "pix")
    rng = np.random.default_rng(41)
    batches = {"random": BT.fuzz_batch(rng, 64),
               "tie-heavy": BT.fuzz_batch(rng, 64, ties=True),
               "small-shape tie-heavy": BT.fuzz_batch(rng, 64, 16, 4, 4,
                                                      ties=True),
               # more in-edge slots than a warp has lanes
               "in-degree 40": BT.fuzz_batch(rng, 64, 16, 40, 4),
               "int32-wrap": _wrap_batch(BT, rng)}
    err = 0.0
    for tag, batch in batches.items():
        host = [t.numpy() for t in BT.bridge_plain(
            *BT.batch_from_numpy(*batch, "cpu"))]
        if tag != "int32-wrap":     # the oracle's Python ints do not wrap
            _outputs_same("%s bridge: the plain form on the host CPU "
                          "against the numpy oracle" % tag, names, host,
                          BT.bridge_dp_host(*batch))
        on_card = BT.batch_from_numpy(*batch, dev)
        if tag == "small-shape tie-heavy":
            # rows one int wider than their data: the unaligned copies
            on_card = [_odd_rows(t) for t in on_card]
        for r in rows:
            sub = [a[:r] for a in on_card]
            kern = [t.cpu().numpy() for t in BT.bridge_cuda(*sub)]
            plain = [t.cpu().numpy() for t in BT.bridge_plain(*sub)]
            want = [h[:r] for h in host]
            err = max(err, _outputs_same(
                "%s bridge, %d rows: the kernel against the plain form on "
                "the host CPU" % (tag, r), names, kern, want))
            err = max(err, _outputs_same(
                "%s bridge, %d rows: the kernel against the plain form on "
                "the card" % (tag, r), names, kern, plain))
        if tag == "tie-heavy":
            ostk = host[0]
            tied = int(((ostk[:, :, 0] == ostk[:, :, 1]).all(axis=-1)
                        & (ostk[:, :, 0, 0] >= 0)).sum())
            require(tied > 0, "the tie-heavy bridge batch has no ties")
            log("bridge tie-heavy batch: %d of %d targets keep two entries "
                "with equal stacks, separated by candidate order only"
                % (tied, int((batch[3] >= 0).sum())))
    log("bridge: csrc/bridge.cu == the plain form on the card == the plain "
        "form on the host CPU == the numpy oracle, every output element for "
        "element (max |diff| %g), at %s rows, on %s batches"
        % (err, " / ".join(str(r) for r in rows), ", ".join(batches)))
    log("ptxas bridge_kernel: %s" % "; ".join(_ptxas_lines("bridge_kernel")))
    for tag in ("random", "tie-heavy"):
        _bridge_split(BT, tag + " production-shape",
                      BT.batch_from_numpy(*batches[tag], dev))

    on_card = BT.batch_from_numpy(*batches["random"], dev)
    times = {}
    for n in rows:
        a = [t[:n] for t in on_card]
        outs = BT.bridge_cuda(*a)
        t = {"device": _device_ms(lambda: BT.bridge_cuda(*a)),
             "profiler": _profiled_ms(lambda: BT.bridge_cuda(*a),
                                      "bridge"),
             "call": _call_ms(lambda: BT.bridge_cuda(*a)),
             # the plain form at 1 and 37 rows only (the script's time)
             "plain": _host_ms(lambda: [t.cpu() for t in BT.bridge_plain(
                 *a)], 3) if n in (1, 37) else None}
        t["bound"], t["bound_by"], t["bytes"] = _bridge_bound(a, outs)
        times[n] = t
        log("bridge kernel nrows=%d (random batch): device %.4f ms (events, "
            "launch cost outside), profiler %.4f ms (%d records for %d "
            "launches; events - profiler %.4f ms); wrapper call %.4f ms; "
            "plain form's call on the card %s (host clock, median of 3); "
            "bound %.7f ms (%s; %d bytes), share of it reached %.4f %%"
            % (n, t["device"], t["profiler"], REPS, REPS,
               _agree("bridge nrows=%d" % n, t), t["call"],
               "%.2f ms" % t["plain"] if t["plain"] is not None
               else "not timed", t["bound"], t["bound_by"], t["bytes"],
               100.0 * t["bound"] / t["device"]))
    # the solver: the live rows only, one copy in, one launch, one copy
    # out, one sync
    def staged():
        bdev = BT.DeviceBridge(device=dev)
        for stage, a in zip((bdev.P, bdev.Wt, bdev.Lv, bdev.tgt),
                            batches["tie-heavy"]):
            stage[...] = a
        return bdev
    bdev = staged()
    want = BT.bridge_dp_host(*(a[:5] for a in batches["tie-heavy"]))
    n0 = BT.bridge_cuda.launches
    got = bdev.solve(5)
    _outputs_same("bridge solve(5) against the numpy oracle", names, got,
                  want)
    require(BT.bridge_cuda.launches == n0 + 1
            and bdev.stats["bridge_launches"] == 1, "a bridge dispatch "
            "launched the kernel %d times" % (BT.bridge_cuda.launches - n0))
    require(all(g.flags["C_CONTIGUOUS"] and not np.shares_memory(
        g, bdev._out.numpy()) for g in got), "bridge solve(): results are "
        "views of the pinned buffer")
    solve = _form_times("bridge solve(), one kernel launch,", bdev.solve,
                        rows, 5, ops=3)
    _mesh_same("bridge solve()", staged, rows,
               lambda: BT.bridge_cuda.launches, names)
    return err, times, solve


def torch_forms_vs_oracles(dev):
    """Phase 2c.  Returns {form: {nrows: times}}, and under "ladder_err" and
    "bridge_err" the kernels' largest absolute differences from their
    plain forms."""
    import numpy as np
    import torch

    from aletsch_tpu_torch.ops import support as SP
    res = {}

    # bridge top-K
    res["bridge_err"], res["bridge_kernel"], res["bridge"] = \
        bridge_vs_plain(dev)

    # support reduce
    sdev = SP.DeviceSupport(device=dev)
    jw = np.random.default_rng(42).integers(
        0, 1000, size=sdev.jw.shape).astype(np.float32)
    for n in (1, 64):
        card = SP.support_sum(torch.from_numpy(jw[:n]).to(dev)).cpu().numpy()
        require(card.dtype == np.float32
                and np.array_equal(card, SP.support_sum_host(jw[:n])),
                "support nrows=%d: the card's sums differ from the numpy "
                "oracle's" % n)
    log("support reduce on the card == numpy oracle, exactly, [n, %d, %d] "
        "at 1 and 64 rows" % jw.shape[1:])
    sdev.jw[...] = jw
    res["support"] = _form_times("support solve()", sdev.solve, (1, 64), 25,
                                 ops=3)

    # ladder
    res["ladder_err"], res["ladder_kernel"], res["ladder"] = \
        ladder_vs_plain(dev)
    return res


# ------------------------------------------------------------ phase 2d
def _exact(tag, got, want):
    import numpy as np
    require(got.shape == want.shape and np.array_equal(got, want),
            "%s differs from its oracle" % tag)


def _close(tag, got, want):
    import numpy as np
    require(got.shape == want.shape
            and np.allclose(got, want, rtol=1e-6, atol=1e-6),
            "%s is not within 1e-6 of its oracle (max |diff| %g)"
            % (tag, float(np.abs(got - want).max(initial=0.0))))


def _check_step(tag, tensors, dev):
    """The wave step on the card against the numpy oracle on the same
    tensors: exact on bottleneck, mx, sim, support, 1e-6 on ave, dev."""
    from aletsch_tpu_torch.parallel import mesh
    from aletsch_tpu_torch.parallel.wave_extract import host_oracle
    want = host_oracle(*tensors)
    args = mesh.batch_from_numpy(*tensors, dev)
    got = mesh.outputs_to_numpy(mesh.step(*args))
    for name, g, w in zip(("bottleneck", "ave", "dev", "mx", "sim",
                           "support"), got, want):
        require(g.flags["C_CONTIGUOUS"], "%s %s is not contiguous"
                % (tag, name))
        (_close if name in ("ave", "dev") else _exact)(
            "%s: the step's %s" % (tag, name), g, w)
    return args


def _capture_cohort(dev):
    """The seven step tensors captured from the two-sample simulated cohort
    (seeds 41, 42) by the port's own pipeline, on the host path."""
    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.parallel.wave_extract import capture_cohort_tensors
    from aletsch_tpu_torch.sim import simulate_sample
    with tempfile.TemporaryDirectory(prefix="aletsch_chip_smoke_cap_") as tmp:
        lines = []
        for i, seed in enumerate((41, 42)):
            bam = os.path.join(tmp, "s%d.bam" % i)
            simulate_sample(bam, seed=seed)
            lines.append("%s %s.bai paired_end\n" % (bam, bam))
        lst = os.path.join(tmp, "bams.list")
        with open(lst, "w") as fh:
            fh.write("".join(lines))
        os.makedirs(os.path.join(tmp, "gtf"))
        params = default_params()
        for p in params:
            p.input_bam_list = lst
            p.output_gtf_file = os.path.join(tmp, "meta.gtf")
            p.output_gtf_dir = os.path.join(tmp, "gtf")
            p.verbose = 0
            for stage in ("greedy", "bridge", "support", "ladder",
                          "similarity"):
                setattr(p, "device_" + stage, "off")
        tensors, info = capture_cohort_tensors(params, B=8, V=32, S=16,
                                               P_=64, Ns=2, J=16)
    require(info["groups"] >= 2 and info["samples"] == 2
            and info["junctions"] >= 1, "the capture degenerated: %s" % info)
    return tensors, info


def _splice_lists(n, npos, seed=17):
    import random
    rng = random.Random(seed)
    return [sorted(rng.sample(range(npos), rng.randint(2, 14)))
            for _ in range(n)]


def new_forms_vs_oracles(dev):
    """Phase 2d.  Returns {form: {size: times}}."""
    import numpy as np
    import torch

    from aletsch_tpu_torch.ops import bottleneck as BN
    from aletsch_tpu_torch.ops import bridge_dp as BD
    from aletsch_tpu_torch.ops import coverage as CV
    from aletsch_tpu_torch.ops import similarity as SM
    from aletsch_tpu_torch.parallel import mesh
    res = {}

    # region stats, f64: the dispatch is numpy in, numpy out
    rng = np.random.default_rng(11)
    batches = {}
    for R in (256, 65536):
        vals = rng.integers(1, 500, size=(R, 16)).astype(np.float64)
        lens = rng.integers(1, 300, size=(R, 16)).astype(np.float64)
        mask = (rng.random((R, 16)) < 0.7).astype(np.float64)
        mask[::97] = 0.0                       # empty regions: the defaults
        span = (lens * mask).sum(axis=1) + rng.integers(0, 100, R)
        batches[R] = (vals, lens, mask, span)

    def stats_dispatch(R):
        out = CV.region_stats(*CV.batch_from_numpy(*batches[R], dev))
        return [np.ascontiguousarray(t.cpu().numpy()) for t in out]

    for R in batches:
        ave, dv, mx = stats_dispatch(R)
        wa, wd, wm = CV.region_stats_host(*batches[R])
        _exact("region_stats R=%d: mx" % R, mx, wm)
        _close("region_stats R=%d: ave" % R, ave, wa)
        _close("region_stats R=%d: dev" % R, dv, wd)
    log("region_stats on the card (f64) against region_stats_host at R = 256 "
        "and 65,536, S = 16: mx exact, ave and dev within 1e-6")
    res["region_stats"] = _form_times("region_stats dispatch",
                                      stats_dispatch, (256, 65536), 25)

    # all-sources bottleneck, [64, 64, 64]
    W = mesh.example_batch(B=64, V=64, seed=5)[0]
    Wd = torch.from_numpy(W).to(dev)
    oracle = BD.bottleneck_all_sources_host(W)
    T = BD.bottleneck_all_sources(Wd)
    _exact("bottleneck_all_sources f32", T.cpu().numpy(),
           oracle.astype(np.float32))
    _exact("bottleneck_all_sources f64",
           BD.bottleneck_all_sources(Wd.double()).cpu().numpy(), oracle)
    row0 = BN.bottleneck_cuda(Wd, False)
    torch.cuda.synchronize()
    require(np.array_equal(_canon(T[:, 0, :].cpu().numpy()),
                           _canon(row0.cpu().numpy())),
            "row 0 of bottleneck_all_sources differs from the bottleneck "
            "kernel's positive form")
    log("bottleneck_all_sources on the card == numpy oracle, exactly, in f32 "
        "and f64 at [64, 64, 64]; its row 0 == the bottleneck kernel's "
        "positive form on the same W")
    res["bottleneck_all_sources"] = _form_times(
        "bottleneck_all_sources",
        lambda n: BD.bottleneck_all_sources(Wd[:n]).cpu(), (1, 64), 5)

    # similarity: the sparse form, and the dense form through a forced
    # overflow of the sparse one, against the host form
    th, cap = SM._DEVICE_THRESHOLD, SM._K_CAP
    lists = {n: _splice_lists(n, max(60, n // 2)) for n in
             (64, 200, 1024, 4096)}
    want = {}
    try:
        SM._DEVICE_THRESHOLD = 10 ** 9
        for n in lists:
            want[n] = SM.pairwise_splice_similarity(lists[n], 0.5)
    finally:
        SM._DEVICE_THRESHOLD = th

    def dense_pairs(n):
        SM._K_CAP = 16          # more candidates than K: the sparse form
        try:                    # declines and the dense form takes over
            return SM.pairwise_splice_similarity(lists[n], 0.5)
        finally:
            SM._K_CAP = cap

    for n in lists:
        st0 = dict(SM.stats)
        require(SM.pairwise_splice_similarity(lists[n], 0.5) == want[n],
                "similarity n=%d: the sparse form's pair list differs from "
                "the host form's" % n)
        require(SM.stats["similarity_sparse"] == st0["similarity_sparse"] + 1,
                "similarity n=%d: the sparse form did not run (%s)"
                % (n, SM.stats))
        require(len(want[n]) > 16, "similarity n=%d: only %d pairs"
                % (n, len(want[n])))
        st0 = dict(SM.stats)
        require(dense_pairs(n) == want[n], "similarity n=%d: the dense "
                "form's pair list differs from the host form's" % n)
        require(SM.stats["similarity_overflow"]
                == st0["similarity_overflow"] + 1
                and SM.stats["similarity_dense"]
                == st0["similarity_dense"] + 1,
                "similarity n=%d: the forced overflow did not reach the "
                "dense form (%s)" % (n, SM.stats))
    log("similarity on the card: sparse form == dense form (forced overflow, "
        "K = 16) == host form, pair lists equal, at n = %s bundles (%s pairs)"
        % (", ".join(str(n) for n in lists),
           ", ".join(str(len(want[n])) for n in lists)))
    res["similarity_sparse"] = _form_times(
        "pairwise_splice_similarity, sparse form,",
        lambda n: SM.pairwise_splice_similarity(lists[n], 0.5),
        tuple(lists), 3)
    res["similarity_dense"] = _form_times(
        "pairwise_splice_similarity, dense form,", dense_pairs,
        tuple(lists), 3)

    return res


def wave_step_vs_oracle(dev):
    """Phase 2d, last part: the wave step.  It runs after phase 2e because
    the capture runs the port's pipeline in this process, which pins the
    host's BLAS pools to one thread, and phase 2e times numpy products."""
    from aletsch_tpu_torch.parallel import mesh
    shape = dict(B=64, V=64, S=16, P_=128, Ns=10, J=64)
    args = _check_step("example_batch", mesh.example_batch(**shape), dev)
    tensors, info = _capture_cohort(dev)
    _check_step("captured cohort", tensors, dev)
    log("wave step on the card == host_oracle (bottleneck, mx, sim, support "
        "exact; ave, dev within 1e-6) on example_batch(%s) and on the "
        "captured 41 / 42 cohort (%d groups, %d junctions, %d splices)"
        % (", ".join("%s=%d" % kv for kv in shape.items()), info["groups"],
           info["junctions"], info["splices"]))
    return _form_times(
        "wave step", lambda n: mesh.outputs_to_numpy(mesh.step(*args)),
        (64,), 5)


# ------------------------------------------------------------ phase 2e
def policy_measurements(smi):
    """Phase 2e: every measurement the policy rests on, each printed as one
    JSON line with the card beside it.  Nothing is required of who wins."""
    from aletsch_tpu_torch.ops import crossover, mfu
    out = {}
    _reset_launches()
    for name, fn in (
            ("measure", lambda: crossover.measure(batches=(64, 256, 1024))),
            ("measure_ladder", crossover.measure_ladder),
            ("measure_similarity",
             lambda: crossover.measure_similarity(reps=2)),
            ("measure_coverage", crossover.measure_coverage),
            ("mfu.measure_all", mfu.measure_all)):
        t0 = time.perf_counter()
        out[name] = fn()
        print(json.dumps({"policy": name, "card": smi,
                          "seconds": round(time.perf_counter() - t0, 2),
                          "result": out[name]}), flush=True)
    for r in out["measure"]["table"]:
        require(r["paths_agree"] and r["bit_exact_vs_host"],
                "measure B=%d: the card's drain disagrees with the native "
                "host drain" % r["B"])
    for r in out["measure_ladder"]["table"]:
        require(r["ndec_agree"] == r["eligible_and_clean"] > 0,
                "measure_ladder B=%d: %d of %d eligible clean graphs agree "
                "with the native host ladder"
                % (r["B"], r["ndec_agree"], r["eligible_and_clean"]))
    for r in out["measure_similarity"]["table"]:
        require(r["counts_identical"], "measure_similarity n=%d: the dense "
                "product differs from numpy's" % r["n_bundles"])
    for r in out["measure_similarity"]["sparse_form"]["rows"]:
        require(r["results_identical"] is True, "measure_similarity n=%d: "
                "the sparse form's pair list differs from the host form's"
                % r["n_bundles"])
    for r in out["measure_coverage"]["table"]:
        require(r["mx_identical"] and r["ave_dev_within_1e-6"],
                "measure_coverage R=%d: the card's stats differ from "
                "numpy's" % r["n_regions"])
    n = _launches()
    require(min(n.values()) > 0,
            "the policy's measurements launched %s: they must run the "
            "drain, the bottleneck, the ladder and the bridge kernels" % n)
    log("the policy's measurements launched the drain kernel %d times, "
        "the bottleneck kernel %d times, the ladder kernel %d times and "
        "the bridge kernel %d times"
        % (n["drain"], n["bottleneck"], n["ladder"], n["bridge"]))
    f = out["measure"]["fit"]
    log("drain fit on this card: a %.4f ms, b %.3f us a graph, c %.3f us a "
        "graph, break_even_B %s; resident %.3f us a graph at B = 64"
        % (f["a_fixed_dispatch_s"] * 1e3, f["b_per_graph_device_s"] * 1e6,
           f["c_per_graph_host_s"] * 1e6, out["measure"]["break_even_B"],
           out["measure"]["table"][0]["resident_us_per_graph"] or -1.0))
    return out


# ------------------------------------------------------------ phase 3
def _outputs(out):
    files = {"meta.gtf": os.path.join(out, "meta.gtf")}
    for f in sorted(os.listdir(os.path.join(out, "gtf"))):
        files["gtf/" + f] = os.path.join(out, "gtf", f)
    out_bytes = {}
    for name, path in files.items():
        with open(path, "rb") as fh:
            out_bytes[name] = fh.read()
    return out_bytes


def _cli_args(out):
    os.makedirs(os.path.join(out, "gtf"))
    return ["-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf")]


def _subprocess_wall(module, lst, out, extra, env):
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", module, "-i", lst,
                    *_cli_args(out), *extra], cwd=REPO, env=env,
                   check=True, timeout=900)
    return time.perf_counter() - t0


def _build_cohort(base, genes, samples, env, kind="paired_end"):
    """The bams.list of a cohort simulated under `base` in a subprocess:
    config 3's paired-end samples (tools/refbuild/baseline.py), or config
    4's ("long_read") or 5's ("smartseq") (aletsch_tpu_torch/cohorts.py,
    a sample a process up to COHORT_JOBS)."""
    t0 = time.perf_counter()
    if kind == "paired_end":
        argv = ["-c", "import sys; from tools.refbuild.baseline import "
                "build_cohort; print(*build_cohort(sys.argv[1], "
                "int(sys.argv[2]), int(sys.argv[3])))"]
    else:
        argv = ["-m", "aletsch_tpu_torch.cohorts", kind]
    made = subprocess.run(
        [sys.executable, *argv, base, str(genes), str(samples),
         *(["--jobs", str(COHORT_JOBS)] if kind != "paired_end" else [])],
        cwd=REPO, env=env, check=True, timeout=600, capture_output=True,
        text=True).stdout.strip().splitlines()[-1].split()
    log("%s cohort %d genes x %d samples, %d records (%.1f s)"
        % (kind, genes, samples, int(made[1]), time.perf_counter() - t0))
    return made[0]


def _require_same(got, ref, what):
    require(sorted(got) == sorted(ref), "output file sets differ: %s vs %s"
            % (sorted(got), sorted(ref)))
    for name in ref:
        require(got[name] == ref[name], "%s of %s differs from the "
                "reference's" % (name, what))


def _traced_cli(tmp, lst, out, env, tag):
    """The port's CLI as a subprocess with the drain forced (DEVICE_ARGS)
    and --jax_profile_dir: its one capture, that of a process as a user
    runs it.  Returns {"wall", "stats" (the device stats line),
    "events" (the trace), "window_s" (the capture's span), "counts"
    (_every_record)}."""
    import ast
    import glob

    from aletsch_tpu_torch.utils import tracing
    trace_dir = os.path.join(tmp, "trace_" + os.path.basename(out))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "aletsch_tpu_torch", "-i", lst,
         *_cli_args(out), *DEVICE_ARGS, "--verbose", "1",
         "--jax_profile_dir", trace_dir], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    require(res.returncode == 0, "%s failed: %s" % (tag, res.stderr[-2000:]))
    lines = [ln for ln in res.stderr.splitlines()
             if ln.startswith("[aletsch_tpu_torch] device:")]
    require(lines, "%s printed no device stats line" % tag)
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    require(len(files) == 1, "%s left %d trace files" % (tag, len(files)))
    events = tracing.read_trace(files[0])
    span = [e for e in events if e.get("cat") == "Trace"]
    require(len(span) == 1, "%s: no capture span in the trace" % tag)
    return {"wall": wall, "events": events, "bytes":
            os.path.getsize(files[0]), "window_s":
            float(span[0]["dur"]) / 1e6, "counts": _every_record(tag, events),
            "stats": ast.literal_eval(lines[-1].split("device:", 1)[1]
                                      .strip())}


def _top_records(events, n=8):
    """The trace's n device records with the largest summed time, by name:
    lines of (calls, ms, name)."""
    from aletsch_tpu_torch.utils import tracing
    by = {}
    for e in events:
        if e.get("cat") in tracing.DEVICE_CATS:
            c, us = by.get(e["name"], (0, 0.0))
            by[e["name"]] = (c + 1, us + float(e.get("dur", 0.0)))
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return "\n".join("  %7d  %10.3f ms  %s" % (c, us / 1000.0, name[:90])
                     for name, (c, us) in top)


def _profiled_run(tag, card, run, kernel, launches):
    """Checks and logs one traced CLI run (_traced_cli): one kernel record
    for each launch of `kernel`, its device time, all device work, and
    the device's idle share over the capture's span and over the
    subprocess's wall."""
    c = run["counts"]
    n, us = _device_us(run["events"], KERNEL_EVENT[kernel])
    _, busy_us = _device_us(run["events"])
    require(n == launches, "the profiled %s run: %d %s kernel records for "
            "%d launches" % (tag, n, kernel, launches))
    log("profiled %s run on %s (the CLI as a subprocess, traced): wall "
        "%.2f s, capture %.2f s; %s kernel device time %.2f ms over %d "
        "records for %d launches; %d device records (%d kernels, %d copies, "
        "%d memsets) for %d queued; all device work %.2f ms; device idle "
        "share %.4f of the capture, %.4f of the wall"
        % (tag, card, run["wall"], run["window_s"], kernel, us / 1000.0, n,
           launches, c["kernel"] + c["gpu_memcpy"] + c["gpu_memset"],
           c["kernel"], c["gpu_memcpy"], c["gpu_memset"], c["enqueued"],
           busy_us / 1000.0, 1.0 - busy_us / 1e6 / run["window_s"],
           1.0 - busy_us / 1e6 / run["wall"]))


def main_path(forms, smi, card, genes=GENES, samples=SAMPLES):
    """Reference and port CLIs on the production cohort.  Returns a dict
    of walls, the profiled run (_traced_cli: its device stats, launch
    counts and trace), and the step path's and the new path's results."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = {}
    with tempfile.TemporaryDirectory(prefix="aletsch_chip_smoke_") as tmp:
        lst = _build_cohort(os.path.join(tmp, "cohort"), genes, samples, env)

        walls = {"reference": [], "port": []}
        ref = None
        for i, side in enumerate(("reference", "port")):
            out = os.path.join(tmp, "%s%d" % (side, i))
            if side == "reference":
                walls[side].append(_subprocess_wall(
                    "aletsch_tpu", lst, out, HOST_ARGS, env))
            else:
                walls[side].append(_subprocess_wall(
                    "aletsch_tpu_torch", lst, out, DEVICE_ARGS,
                    dict(env, ALETSCH_TORCH_DEVICE="cuda")))
            got = _outputs(out)
            if ref is None:
                ref = got
            _require_same(got, ref, "%s run %d" % (side, i))
        log("subprocess walls (s): reference %s, port %s; every output "
            "byte-identical (%d files, meta.gtf %d bytes)"
            % (walls["reference"], walls["port"], len(ref),
               len(ref["meta.gtf"])))

        # the profiled port run: the CLI as a subprocess with its trace
        out = os.path.join(tmp, "profiled")
        prof = _traced_cli(tmp, lst, out, _trace_env(tmp, env),
                           "the profiled port run")
        _require_same(_outputs(out), ref, "the profiled port run")
        res["profiled"] = prof
        print(_top_records(prof["events"]), flush=True)
        # the small cohort of phases 3b to 3h, and its reference bytes
        small = _build_cohort(os.path.join(tmp, "cohort_small"), SMALL_GENES,
                              samples, env)
        out = os.path.join(tmp, "reference_small")
        wall = _subprocess_wall("aletsch_tpu", small, out, HOST_ARGS, env)
        small_ref = _outputs(out)
        log("%d-gene cohort: reference subprocess wall %.2f s (%d files)"
            % (SMALL_GENES, wall, len(small_ref)))
        res["step"] = step_path(tmp, small, small_ref, env)
        res["new"] = new_path(tmp, lst, ref, small, small_ref, forms, genes)
        res["default"] = default_path(tmp, lst, ref, env, small, small_ref)
        res["scoring"] = scoring_path(tmp, os.path.join(tmp, "port1", "gtf"),
                                      samples, env)
        res["jobs"] = jobs_path(tmp, small, small_ref, env)
        res["mesh"] = mesh_path(tmp, small, small_ref, env, smi)
        res["protocols"] = protocols_path(tmp, env, card)
        res["bench"] = bench_path(tmp, env, smi)
    res["walls"] = walls
    return res


def _trace_env(tmp, env, **extra):
    """The environment of a traced CLI subprocess: jax and the JAX package
    unimportable (CHILD_SHIM), the card, and the profiler's default of
    one CUPTI kept for the process (its only capture)."""
    cenv = dict(_child_env(tmp, env), **extra)
    cenv.pop("TEARDOWN_CUPTI", None)
    return cenv


def step_path(tmp, lst, ref, env):
    """Phase 3b: the port's CLI in step mode as a subprocess with its
    trace."""
    out = os.path.join(tmp, "step_profiled")
    res = _traced_cli(tmp, lst, out, _trace_env(
        tmp, env, ALETSCH_DEVICE_GREEDY="step"), "the profiled step-mode run")
    _require_same(_outputs(out), ref, "the profiled step-mode run")
    print(_top_records(res["events"]), flush=True)
    return res


# ------------------------------------------------------------ phase 3c
def _in_process_run(lst, out, extra, trust):
    """The port's CLI in this process with every solver, count and
    agreement counter reset just before it.  trust=False runs verify mode
    (ALETSCH_FUSED_TRUST=0).  Returns (wall, device stats, launches)."""
    import torch

    from aletsch_tpu_torch import __main__ as port_main
    from aletsch_tpu_torch.meta import device_wave, native_core
    args = ["-i", lst, *_cli_args(out), *DEVICE_ARGS, *extra]
    if not trust:
        os.environ["ALETSCH_FUSED_TRUST"] = "0"
    try:
        device_wave.reset_solvers()
        for k in device_wave.stats:
            device_wave.stats[k] = 0
        native_core.fused_stats[:] = 0
        native_core.ladder_stats[:] = 0
        _reset_launches()
        t0 = time.perf_counter()
        require(port_main.main(args) == 0, "port CLI failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall, device_wave.device_stats(), _launches()
    finally:
        os.environ.pop("ALETSCH_FUSED_TRUST", None)


def _check_new_path(tag, st, n, stages, trust):
    """The engagement and agreement checks of one in-process run of the
    new path."""
    require(n["bottleneck"] == 0, "%s launched the bottleneck kernel" % tag)
    require(st.get("fused_graphs", 0) > 0, "%s: the drain never engaged" % tag)
    require(n["drain"] >= st["fused_dispatches"] > 0,
            "%s: drain launches %d < dispatches %d"
            % (tag, n["drain"], st["fused_dispatches"]))
    require(st["fused_trust"] is trust, "%s: fused_trust is %s"
            % (tag, st["fused_trust"]))
    require(st["fused_agree"] == st["fused_total"] > 0,
            "%s: device paths disagree with the host drain (%d of %d)"
            % (tag, st["fused_agree"], st["fused_total"]))
    keys = {"bridge": ("device_bridge_insts", "bridge_dispatches"),
            "support": ("device_support_groups", "support_dispatches"),
            "ladder": ("device_ladder_graphs", "ladder_dispatches",
                       "ladder_decisions", "ladder_iterations")}
    for stage in stages:
        for k in keys[stage]:
            require(st.get(k, 0) > 0, "%s: %s is %s: the %s stage never "
                    "engaged" % (tag, k, st.get(k), stage))
    if "bridge" in stages:
        # one kernel launch a dispatch on one card, timed by its events
        require(st.get("bridge_kernel_time", 0) > 0, "%s: no bridge kernel "
                "time" % tag)
        require(n["bridge"] == st["bridge_dispatches"]
                == st["bridge_launches"] > 0,
                "%s: %d bridge kernel launches (%d by the solver) for %d "
                "dispatches" % (tag, n["bridge"], st["bridge_launches"],
                                st["bridge_dispatches"]))
    if "ladder" in stages:
        # one kernel launch a dispatch on one card: no replay of the plain
        # body, no read of pc between events
        require(n["ladder"] == st["ladder_dispatches"] > 0,
                "%s: %d ladder kernel launches for %d dispatches"
                % (tag, n["ladder"], st["ladder_dispatches"]))
        require(st["ladder_trust"] is trust, "%s: ladder_trust is %s"
                % (tag, st["ladder_trust"]))
        require(st["ladder_agree"] == st["ladder_total"] > 0,
                "%s: the card's ladder decisions disagree with the host's "
                "(%d of %d)" % (tag, st["ladder_agree"], st["ladder_total"]))


class _BridgeRows:
    """Phase 3c's view of the bridge's dispatches, while active: the staged
    rows of the first `keep` dispatches (copies), and over every dispatch
    histograms of each instance's live length (its last vertex with a live
    in-edge or a target, + 1) and of the valid candidates of each step
    before it (the entries of its live predecessors, from the dispatch's
    own pix).  Its own work in the run's clock is kept in `seconds`."""

    LIVE_BINS = (1, 2, 3, 4, 5, 9, 17, 33, 65)
    CAND_BINS = (0, 1, 2, 5, 11, 33, 161)

    def __init__(self, keep=64):
        import numpy as np
        self.keep = keep
        self.sample = []
        self.live = np.zeros(len(self.LIVE_BINS) - 1, np.int64)
        self.cands = np.zeros(len(self.CAND_BINS) - 1, np.int64)
        self.steps = 0
        self.seconds = 0.0

    def __enter__(self):
        from aletsch_tpu_torch.ops import bridge_topk as BT
        self._orig = orig = BT.DeviceBridge.solve
        view = self

        def solve(solver, nrows):
            t0 = time.perf_counter()
            rows = tuple(a[:nrows] for a in (solver.P, solver.Wt, solver.Lv,
                                             solver.tgt))
            if len(view.sample) < view.keep:
                view.sample.append(tuple(a.copy() for a in rows))
            t1 = time.perf_counter()
            out = orig(solver, nrows)
            t2 = time.perf_counter()
            view.add(rows[0], rows[3], out[2])
            view.seconds += t1 - t0 + time.perf_counter() - t2
            return out
        BT.DeviceBridge.solve = solve
        return self

    def __exit__(self, *exc):
        from aletsch_tpu_torch.ops import bridge_topk as BT
        BT.DeviceBridge.solve = self._orig

    def add(self, P, tgt, pix):
        """Count one dispatch's instances: P, tgt its staged rows, pix its
        entry-index table."""
        import numpy as np
        n, V, _ = P.shape
        live = (P >= 0) & (P < V)
        k = np.arange(V)
        last = np.where(live.any(axis=2), k, -1).max(axis=1)
        last = np.maximum(last, np.where((tgt >= 0) & (tgt < V), tgt,
                                         -1).max(axis=1))
        length = last + 1
        self.live += np.histogram(length, self.LIVE_BINS)[0]
        entries = (pix >= 0).sum(axis=2)
        entries[:, 0] = 1
        m = (entries[np.arange(n)[:, None, None], np.clip(P, 0, V - 1)]
             * live).sum(axis=2)
        # the steps each instance runs: 1 .. its last live in-edge's vertex
        run = (k[None, :] >= 1) & (k[None, :] <= np.where(
            live.any(axis=2), k, -1).max(axis=1)[:, None])
        self.cands += np.histogram(m[run], self.CAND_BINS)[0]
        self.steps += int(run.sum())

    def report(self):
        def bins(edges, counts):
            return ", ".join(
                "%s: %d" % (("%d" % lo) if hi - lo == 1
                            else "%d-%d" % (lo, hi - 1), c)
                for lo, hi, c in zip(edges, edges[1:], counts))
        log("bridge instances' live length (last vertex with a live in-edge "
            "or a target, + 1): %s (%d instances)"
            % (bins(self.LIVE_BINS, self.live), int(self.live.sum())))
        log("bridge valid candidates a step, over the %d steps before each "
            "instance's last live in-edge: %s"
            % (self.steps, bins(self.CAND_BINS, self.cands)))
        log("bridge watcher: its own work took %.3f s of the watched run's "
            "wall" % self.seconds)

    def time_sample(self, dev):
        """The kernel over the sample's dispatches, each its own launch, as
        the cohort ran them (_bridge_dispatches), then the profiling
        instance's split over the first 64 instances."""
        import numpy as np

        from aletsch_tpu_torch.ops import bridge_topk as BT
        _bridge_dispatches(BT, self.sample, dev, "as staged")
        rows = [np.concatenate([r[i] for r in self.sample])[:64]
                for i in range(4)]
        _bridge_split(BT, "the cohort's own rows",
                      BT.batch_from_numpy(*rows, dev))


def _events_ms(calls, reps):
    """Median over reps of the summed device time of the calls, each
    between CUDA events, all queued behind a spin of the stream."""
    import torch
    sums = []
    for _ in range(reps):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in calls]
        torch.cuda.synchronize()
        torch.cuda._sleep(4 * SPIN_CYCLES)
        for (e0, e1), call in zip(ev, calls):
            e0.record()
            call()
            e1.record()
        require(not ev[0][0].query(), "the spin ended before the launches "
                "were queued")
        torch.cuda.synchronize()
        sums.append(sum(e0.elapsed_time(e1) for e0, e1 in ev))
    return statistics.median(sums)


def _bridge_dispatches(BT, sample, dev, tag, reps=5):
    """bridge_cuda (of the module BT) over a list of staged dispatches (P,
    Wt, Lv, tgt numpy rows), each its own launch: every output equal to
    the plain form's on the host CPU; logs and returns the launches'
    summed device time, ms (_events_ms)."""
    names = ("ostk", "par", "pix")
    on_card = [BT.batch_from_numpy(*r, dev) for r in sample]
    for r, c in zip(sample, on_card):
        _outputs_same("bridge on the cohort's own rows: the kernel against "
                      "the plain form on the host CPU", names,
                      [t.cpu().numpy() for t in BT.bridge_cuda(*c)],
                      [t.numpy() for t in BT.bridge_plain(
                          *BT.batch_from_numpy(*r, "cpu"))])
    ms = _events_ms([lambda c=c: BT.bridge_cuda(*c) for c in on_card], reps)
    log("bridge kernel on the cohort's first %d dispatches (%d instances, "
        "%s): == the plain form on the host CPU; device %.4f ms in all, "
        "%.4f ms a launch (CUDA events around each launch, median of %d)"
        % (len(sample), sum(len(r[0]) for r in sample), tag, ms,
           ms / len(sample), reps))
    return ms


def new_path(tmp, lst, ref, small, small_ref, forms, genes):
    """Phase 3c: the bridge, support and ladder stages through the port's
    CLI on the card, on the production cohort in trust mode and on the
    small cohort in verify mode (phase 3i's config 4 checks verify mode
    decision for decision at scale); in the verify run, the bridge's
    dispatches are watched (_BridgeRows), and its kernel is then timed on
    the first 64 dispatches' rows."""
    ms = forms["ladder"][3]["host_ms"]
    projected = LADDER_DISPATCHES_PER_GENE * genes * ms / 1e3
    log("ladder projection: %.3f ms of host clock a 3-row dispatch (phase "
        "2c) x %.3f dispatches a gene x %d genes = %.1f s of solve() a run"
        % (ms, LADDER_DISPATCHES_PER_GENE, genes, projected))
    res = {"projected": projected, "runs": []}
    extra = BRIDGE_SUPPORT_ARGS + LADDER_ARGS
    stages = ("bridge", "support", "ladder")
    for trust, cohort, want, n_genes in ((True, lst, ref, genes),
                                         (False, small, small_ref,
                                          SMALL_GENES)):
        mode = "trust" if trust else "verify"
        out = os.path.join(tmp, "new_" + mode)
        if trust:
            wall, st, n = _in_process_run(cohort, out, extra, trust)
        else:
            with _BridgeRows() as rows:
                wall, st, n = _in_process_run(cohort, out, extra, trust)
        _require_same(_outputs(out), want, "the new path's %s-mode run"
                      % mode)
        tag = "%d genes, %s, %s" % (n_genes, "+".join(stages), mode)
        _check_new_path(tag, st, n, stages, trust)
        res["runs"].append((tag, wall, st, n))
    rows.report()
    rows.time_sample("cuda")
    return res


# ------------------------------------------------------------ phase 3d
# stage -> the counters of device_stats() that count what it sent to the card
STAGE_COUNTS = {"drain": ("fused_graphs",),
                "bridge": ("device_bridge_insts",),
                "support": ("device_support_groups",),
                "ladder": ("device_ladder_graphs",),
                "similarity": ("similarity_sparse", "similarity_dense")}


def _default_run(lst, out, env, extra=()):
    """The port's CLI as a subprocess with no --device_* flag but `extra`.
    Returns (wall, the device stats of its last stderr line)."""
    import ast
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "aletsch_tpu_torch", "-i", lst,
         *_cli_args(out), *DEFAULT_ARGS, *extra], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    require(res.returncode == 0, "the port's CLI failed at its defaults: %s"
            % res.stderr[-2000:])
    lines = [ln for ln in res.stderr.splitlines()
             if ln.startswith("[aletsch_tpu_torch] device:")]
    require(lines, "the port's CLI printed no device stats line")
    return wall, ast.literal_eval(lines[-1].split("device:", 1)[1].strip())


def _sent(st, stage):
    return sum(st.get(k, 0) for k in STAGE_COUNTS[stage])


def default_path(tmp, lst, ref, env, small, small_ref):
    """Phase 3d: the production cohort through the port's CLI at its
    defaults ('auto' everywhere) and its ALETSCH_DEVICE=0 twin; the small
    cohort at the defaults with --device_min_groups 0, where 'auto' asks
    the policy; then --device_similarity on in this process on the small
    cohort with every subset on the card."""
    from aletsch_tpu_torch.ops import crossover
    from aletsch_tpu_torch.ops import similarity as SM
    policy_tmp = os.path.join(tmp, "policy_tmp")
    os.makedirs(policy_tmp)
    # a temporary directory of its own: no calibration is cached there
    cuda_env = dict(env, ALETSCH_TORCH_DEVICE="cuda", TMPDIR=policy_tmp)
    cache = os.path.join(policy_tmp, os.path.basename(crossover.cache_path()))
    res = {}
    out = os.path.join(tmp, "default_auto")
    res["wall_auto"], st = _default_run(lst, out, cuda_env)
    _require_same(_outputs(out), ref, "the default ('auto') run")
    # its waves hold fewer groups than device_min_groups: no stage asks
    require(not os.path.exists(cache), "the default run measured a "
            "calibration: %s" % os.path.basename(cache))
    require(not st.get("auto", {}).get("calibrated", False)
            and not any(_sent(st, s) for s in STAGE_COUNTS),
            "the default run calibrated or reached the card: %s" % st)
    out = os.path.join(tmp, "default_off")
    res["wall_off"], st_off = _default_run(
        lst, out, dict(cuda_env, ALETSCH_DEVICE="0"))
    _require_same(_outputs(out), ref, "the default run with ALETSCH_DEVICE=0")
    require("auto" not in st_off and not any(
        _sent(st_off, s) for s in STAGE_COUNTS),
        "ALETSCH_DEVICE=0 still asked the policy or reached the card: %s"
        % st_off)
    log("default run ('auto' everywhere) wall %.2f s, no calibration, "
        "nothing asked of the policy (%s); with ALETSCH_DEVICE=0 %.2f s; both "
        "byte-identical to the reference (%d files)"
        % (res["wall_auto"], st.get("auto"), res["wall_off"], len(ref)))

    # --device_min_groups 0 on the small cohort: 'auto' asks at every wave,
    # and the first question measures the calibration
    out = os.path.join(tmp, "default_min_groups_0")
    res["wall_asked"], st = _default_run(small, out, cuda_env,
                                         ["--device_min_groups", "0"])
    _require_same(_outputs(out), small_ref,
                  "the default run with --device_min_groups 0")
    require(os.path.isfile(cache), "the run that asks left no calibration "
            "at %s" % os.path.basename(cache))
    with open(cache) as fh:
        cal = json.load(fh)
    auto = st.get("auto")
    require(auto and auto["calibrated"], "the run with --device_min_groups 0 "
            "never asked the policy: %s" % st)
    res["calibration_s"] = cal["measured_in_s"]
    res["cal"], res["stats"] = cal, st
    log("%d-gene cohort at the defaults with --device_min_groups 0: wall "
        "%.2f s, of which the one-off calibration %.2f s; byte-identical"
        % (SMALL_GENES, res["wall_asked"], cal["measured_in_s"]))
    engaged = {}
    for stage in crossover.STAGES:
        asked = auto["asked"].get(stage, {})
        for n, ans in asked.items():
            want = crossover.stage_wins(stage, n, cal)
            require(ans == want, "'auto' answered %s for %s at %d "
                    "instances; its fit says %s" % (ans, stage, n, want))
        engaged[stage] = any(asked.values())
    in_wave = any(engaged[s] for s in ("drain", "bridge", "support",
                                       "ladder"))
    res["policy"] = {}
    for stage in crossover.STAGES:
        sub = crossover.stage_calibration(cal, stage)
        asked = auto["asked"].get(stage, {})
        sent = _sent(st, stage)
        # a wave that any stage engages runs its drains on the card too
        may = in_wave if stage == "drain" else engaged[stage]
        require(may or sent == 0, "%s sent %d instances to the card though "
                "its fit loses at every size asked" % (stage, sent))
        f = sub["fit"] if sub else {}
        res["policy"][stage] = dict(
            a_ms=f.get("a_fixed_dispatch_s", 0.0) * 1e3,
            b_us=f.get("b_per_graph_device_s", 0.0) * 1e6,
            c_us=f.get("c_per_graph_host_s", 0.0) * 1e6,
            break_even=sub.get("break_even_B") if sub else None,
            asked=len(asked), sizes=(min(asked), max(asked)) if asked
            else None, yes=sum(asked.values()), sent=sent)
        p = res["policy"][stage]
        log("  'auto' %s: fit a %.4f ms, b %.3f us, c %.3f us an instance, "
            "break-even %s; asked at %d sizes (%s), yes at %d; instances "
            "sent to the card %d"
            % (stage, p["a_ms"], p["b_us"], p["c_us"], p["break_even"],
               p["asked"], "%d to %d" % p["sizes"] if p["sizes"] else "none",
               p["yes"], sent))

    # --device_similarity on with every subset of two or more bundles sent
    # to the card, in this process on the small cohort
    th = SM._DEVICE_THRESHOLD
    SM._DEVICE_THRESHOLD = 2
    try:
        out = os.path.join(tmp, "similarity_forced")
        wall, st_forced, _ = _in_process_run(
            small, out, ["--device_similarity", "on"], True)
    finally:
        SM._DEVICE_THRESHOLD = th
    _require_same(_outputs(out), small_ref,
                  "the run with every subset's similarity on the card")
    require(st_forced["similarity_sparse"] > 0,
            "the similarity form never ran: %s" % st_forced)
    res["similarity_forced"] = (wall, {k: st_forced[k] for k in SM.stats})
    log("--device_similarity on with every subset of >= 2 bundles on the "
        "card, %d-gene cohort, in process: wall %.2f s, byte-identical; %s"
        % (SMALL_GENES, wall, res["similarity_forced"][1]))
    return res


# ------------------------------------------------------------ phase 3e
# A sitecustomize for the port's subprocesses: jax and aletsch_tpu cannot
# be imported there (nor in the processes they spawn, which inherit
# PYTHONPATH), and at exit each process prints its kernel launches and
# forest dispatches as one stderr line, read by phases 3e and 3f.
CHILD_SHIM = """import sys
for _m in %r:
    sys.modules[_m] = None


def _report():
    import json
    counts = {}
    for mod, wrapper in (("drain", "drain_cuda"),
                         ("bottleneck", "bottleneck_cuda")):
        m = sys.modules.get("aletsch_tpu_torch.ops." + mod)
        counts[mod] = getattr(m, wrapper).launches if m else 0
    f = sys.modules.get("aletsch_tpu_torch.scoring.forest")
    if f is not None:
        counts.update(f.stats)
    args = sys.argv[1:]
    role = "rank" + args[args.index("--jax_dist") + 1] \
        if "--jax_dist" in args else " ".join(args[:1]) or "-"
    # one write(2) of the whole line: the workers of a run share the
    # pipe and exit together, and a line written in parts interleaves
    import os
    sys.stderr.flush()
    os.write(2, ("[chip_smoke child] %%s %%s\\n"
                 %% (role, json.dumps(counts))).encode())


import atexit
atexit.register(_report)
"""
CHILD_RE = re.compile(r"^\[chip_smoke child\] (\S+) (\{.*\})$", re.M)
FOREST_ROWS = (256, 4096, 65536)


def _child_env(tmp, env, blocked=("jax", "aletsch_tpu")):
    """env with CHILD_SHIM first on PYTHONPATH, blocking `blocked`."""
    shim = tempfile.mkdtemp(prefix="shim_", dir=tmp)
    with open(os.path.join(shim, "sitecustomize.py"), "w") as fh:
        fh.write(CHILD_SHIM % (tuple(blocked),))
    return dict(env, ALETSCH_TORCH_DEVICE="cuda",
                PYTHONPATH=os.pathsep.join([shim, REPO]))


def _child_run(argv, env):
    """(wall, [(role, counts)] of every process that reported) of one
    subprocess run of `python -m argv...`."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *argv], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    require(res.returncode == 0, "python -m %s failed: %s"
            % (" ".join(argv[:1]), res.stderr[-2000:]))
    return wall, [(role, json.loads(c))
                  for role, c in CHILD_RE.findall(res.stderr)]


def _forest_times(tag, fa, n, seed):
    """predict_proba on the card against _predict_numpy on n seeded rows,
    bit for bit; the host clock of a call, the device time and device
    kernels and copies of one call, and _predict_numpy's time."""
    import numpy as np

    from aletsch_tpu_torch.scoring import forest as F
    X = np.random.default_rng(seed).standard_normal((n, 50)) \
        .astype(np.float32)
    t0 = time.perf_counter()
    want = F._predict_numpy(fa, X)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    d0 = F.stats["forest_dispatches"]
    got = F.predict_proba(fa, X)
    require(F.stats["forest_dispatches"] == d0 + 1,
            "%s, %d rows: predict_proba did not dispatch to the card"
            % (tag, n))
    require(got.dtype == want.dtype == np.float32
            and np.array_equal(got.view(np.int32), want.view(np.int32)),
            "%s, %d rows: the card's probabilities differ from "
            "_predict_numpy (max |diff| %g)"
            % (tag, n, float(np.abs(got - want).max())))
    t = {"rows": n, "numpy_ms": numpy_ms,
         "host_ms": _host_ms(lambda: F.predict_proba(fa, X), 5)}
    t["device_ms"], t["kernels"], _ = _dispatch_profile(
        "forest %s, %d rows" % (tag, n), lambda: F.predict_proba(fa, X))
    return t


def scoring_path(tmp, gtf_dir, samples, env):
    """Phase 3e: the score CLIs on the feature CSVs of `gtf_dir`, then the
    forest on the card against _predict_numpy, timed."""
    import numpy as np

    from aletsch_tpu_torch.scoring import forest as F
    from aletsch_tpu_torch.scoring import score as S
    t0 = time.perf_counter()
    model = os.path.join(REPO, "tests", "fixtures", "rf_model_50f.npz")
    res = {}
    out = {}
    for side, module, cenv in (
            ("port", "aletsch_tpu_torch.scoring.score", _child_env(tmp, env)),
            ("reference", "aletsch_tpu.scoring.score",
             _child_env(tmp, env, blocked=("jax",)))):
        out[side] = os.path.join(tmp, "scores_%s.csv" % side)
        res[side + "_wall"], reports = _child_run(
            [module, "-i", gtf_dir, "-m", model, "-c", str(samples), "-o",
             out[side], "-p", "0.0"], cenv)
        if side == "port":
            res["cli_counts"] = reports[-1][1]
    with open(out["port"], "rb") as fh:
        got = fh.read()
    with open(out["reference"], "rb") as fh:
        want = fh.read()
    require(got == want, "the port's scores CSV differs from the "
            "reference's")
    meta, X = S.load_feature_rows(gtf_dir, samples)
    fa = F.ForestArrays.load(model)
    res["csv_rows"], res["meta_tids"] = len(meta), got.count(b"\n") - 1
    c = res["cli_counts"]
    if len(meta) >= 256:
        require(c.get("forest_dispatches") == 1
                and c.get("forest_rows") == len(meta),
                "the score CLI's forest did not run on the card: %s" % c)
    else:
        # below 256 rows both packages score in numpy: run the card path
        # on the same rows in this process
        p = F._get_torch_predict(fa.max_depth)(
            fa.feature, fa.threshold, fa.left, fa.right, fa.prob, X)
        require(np.array_equal(p.view(np.int32),
                               F._predict_numpy(fa, X).view(np.int32)),
                "the card's probabilities differ from _predict_numpy")
    log("score CLIs on the %d feature rows (%d meta transcripts) of the "
        "port's run: scores CSV byte-identical (%d bytes); port wall %.2f "
        "s, reference wall %.2f s; the port's forest: %s"
        % (len(meta), res["meta_tids"], len(got), res["port_wall"],
           res["reference_wall"], c))
    res["times"] = {}
    for tag, forest in (("fixture", fa), ("synthetic", F.synthetic_forest())):
        for n in FOREST_ROWS:
            r = _forest_times(tag, forest, n, seed=n)
            res["times"][tag, n] = r
            log("forest %s (%d trees, %d nodes, max_depth %d), %d rows: "
                "card == _predict_numpy bit for bit; host clock %.3f ms a "
                "call (median of 5), device %.3f ms in %g kernels and "
                "copies, one record for each queued; _predict_numpy %.3f ms"
                % (tag, forest.feature.shape[0], forest.feature.shape[1],
                   forest.max_depth, n, r["host_ms"], r["device_ms"],
                   r["kernels"], r["numpy_ms"]))
    log("phase 3e took %.1f s" % (time.perf_counter() - t0))
    return res


# ------------------------------------------------------------ phase 3f
def jobs_path(tmp, small, small_ref, env):
    """Phase 3f on the small cohort: --jobs 2, then a --shard /
    --merge_shards round."""
    t0 = time.perf_counter()
    cenv = _child_env(tmp, env)
    res = {}
    out = os.path.join(tmp, "jobs2")
    res["wall"], reports = _child_run(
        ["aletsch_tpu_torch", "-i", small, *_cli_args(out), *DEVICE_ARGS,
         "--jobs", "2"], cenv)
    _require_same(_outputs(out), small_ref, "the --jobs 2 run")
    workers = [c for role, c in reports if role == "shard"]
    require(len(workers) == 2 and all(c["drain"] > 0 for c in workers),
            "each --jobs worker must launch the drain kernel: %s" % reports)
    res["worker_launches"] = [c["drain"] for c in workers]
    log("--jobs 2, drain forced, %d-gene cohort: wall %.2f s; every "
        "output byte-identical (%d files); drain launches per worker %s"
        % (SMALL_GENES, res["wall"], len(small_ref), res["worker_launches"]))
    dumps = [os.path.join(tmp, "shard%d.pkl" % h) for h in range(2)]
    procs = []
    t1 = time.perf_counter()
    for h in range(2):
        out = os.path.join(tmp, "shard%d" % h)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "aletsch_tpu_torch", "-i", small,
             *_cli_args(out), *DEVICE_ARGS, "--shard", str(h), "2",
             "--shard_dump", dumps[h]], cwd=REPO, env=cenv,
            stderr=subprocess.PIPE, text=True))
    shard_launches = []
    for p in procs:
        _, err = p.communicate(timeout=900)
        require(p.returncode == 0, "a --shard run failed: %s" % err[-2000:])
        shard_launches += [json.loads(c)["drain"]
                           for _, c in CHILD_RE.findall(err)]
    out = os.path.join(tmp, "merged")
    merge_wall, _ = _child_run(
        ["aletsch_tpu_torch", "-i", small, *_cli_args(out), *DEVICE_ARGS,
         "--merge_shards", ",".join(dumps)], cenv)
    _require_same(_outputs(out), small_ref, "the merged shards")
    res["shard_wall"] = time.perf_counter() - t1
    res["shard_launches"] = shard_launches
    log("--shard 0 2 / --shard 1 2 (side by side) and --merge_shards, "
        "%d-gene cohort: %.2f s (the merge %.2f s); every output "
        "byte-identical (%d files); drain launches per shard %s"
        % (SMALL_GENES, res["shard_wall"], merge_wall, len(small_ref),
           shard_launches))
    log("phase 3f took %.1f s" % (time.perf_counter() - t0))
    return res


# ------------------------------------------------------------ phase 3g
def trace_path(tmp, small, small_ref, env):
    """Phase 3g: the forced drain with --jax_profile_dir, the CLI as a
    subprocess; the trace must hold one drain kernel record for each
    launch, and a device record for every kernel and copy queued."""
    t0 = time.perf_counter()
    out = os.path.join(tmp, "traced")
    tr = _traced_cli(tmp, small, out, _trace_env(tmp, env),
                     "the --jax_profile_dir run")
    _require_same(_outputs(out), small_ref, "the traced run")
    launches = tr["stats"]["drain_launches"]
    n, us = _device_us(tr["events"], KERNEL_EVENT["drain"])
    require(n == launches > 0, "the trace holds %d drain kernel records for "
            "%d launches" % (n, launches))
    c = tr["counts"]
    res = {"bytes": tr["bytes"], "events": len(tr["events"]),
           "kernels": c["kernel"], "drain_events": n, "drain_us": us}
    log("--jax_profile_dir, %d-gene cohort, drain forced (a subprocess): "
        "byte-identical; the trace: %d bytes, %d events; %d device records "
        "(%d kernels, %d copies, %d memsets) for %d queued; %d drain kernel "
        "records for %d launches (%.1f us)"
        % (SMALL_GENES, res["bytes"], res["events"],
           c["kernel"] + c["gpu_memcpy"] + c["gpu_memset"], c["kernel"],
           c["gpu_memcpy"], c["gpu_memset"], c["enqueued"], n, launches, us))
    log("phase 3g took %.1f s" % (time.perf_counter() - t0))
    return res


# ------------------------------------------------------------ phase 3h
MESH_SHARDS = (2, 4, 8)


def mesh_path(tmp, small, small_ref, env, smi):
    """Phase 3h: --jax_dist_launch 2 with the drain forced on the small
    cohort; dryrun_multichip over this machine's cards; the sharded step
    over 2, 4 and 8 shards all placed on cuda:0 (an emulation of a mesh on
    one card) against the one-device step and the host oracle; the weak
    scaling shape at one device."""
    import numpy as np
    import torch

    from aletsch_tpu_torch.graft_entry import dryrun_multichip
    from aletsch_tpu_torch.parallel import mesh, scaling
    from aletsch_tpu_torch.parallel.wave_extract import host_oracle
    t0 = time.perf_counter()
    res = {}
    out = os.path.join(tmp, "jax_dist")
    res["dist_wall"], reports = _child_run(
        ["aletsch_tpu_torch", "-i", small, *_cli_args(out), *DEVICE_ARGS,
         "--jax_dist_launch", "2"], _child_env(tmp, env))
    _require_same(_outputs(out), small_ref, "the --jax_dist_launch 2 run")
    ranks = sorted((role, c["drain"]) for role, c in reports
                   if role.startswith("rank"))
    require(len(ranks) == 2 and all(n > 0 for _, n in ranks),
            "each --jax_dist rank must launch the drain kernel: %s" % reports)
    res["rank_launches"] = dict(ranks)
    log("--jax_dist_launch 2 (gloo, both ranks on this card), drain forced, "
        "%d-gene cohort: wall %.2f s; every output byte-identical to the "
        "reference CLI's, as every one-process port run on this cohort is "
        "(%d files); drain launches per rank %s"
        % (SMALL_GENES, res["dist_wall"], len(small_ref),
           res["rank_launches"]))

    n_cards = torch.cuda.device_count()
    _reset_launches()
    t1 = time.perf_counter()
    dryrun_multichip(n_cards)
    res["dryrun_s"] = time.perf_counter() - t1
    res["dryrun_launches"] = _launches()["drain"]
    log("dryrun_multichip(%d): the sharded step on real wave tensors == the "
        "one-device step == host_oracle, and the pipeline with every device "
        "stage on byte-identical to the host path, in %.2f s (drain "
        "launches %d)" % (n_cards, res["dryrun_s"], res["dryrun_launches"]))

    dev = torch.device("cuda", 0)
    tensors, _ = _capture_cohort(dev)
    want = host_oracle(*tensors)
    args = mesh.batch_from_numpy(*tensors, dev)
    single = mesh.outputs_to_numpy(mesh.step(*args))
    names = ("bottleneck", "ave", "dev", "mx", "sim", "support")
    res["step_ms"] = {1: _host_ms(lambda: mesh.outputs_to_numpy(
        mesh.step(*args)), 5)}
    for n in MESH_SHARDS:
        m = mesh.make_mesh(n, devices=[dev] * n)
        fn = mesh.build_sharded_step(m)
        got = mesh.outputs_to_numpy(fn(*args))
        for name, g, w1, w in zip(names, got, single, want):
            check = _close if name in ("ave", "dev") else _exact
            check("%d shards: %s against the one-device step" % (n, name),
                  g, w1)
            check("%d shards: %s against the host oracle" % (n, name), g, w)
        res["step_ms"][n] = _host_ms(
            lambda: mesh.outputs_to_numpy(fn(*args)), 5)
        log("sharded step, EMULATION: %d shards (data %d x sample %d) all "
            "on cuda:0, on the captured 41 / 42 wave: == the one-device "
            "step == host_oracle (bottleneck, mx, sim, support exact; ave, "
            "dev within 1e-6); host clock a call %.3f ms (one device %.3f)"
            % (n, m.shape["data"], m.shape["sample"], res["step_ms"][n],
               res["step_ms"][1]))
    res["scaling"] = scaling.measure_scaling_shape([1])
    print(json.dumps({"scaling_shape": res["scaling"], "card": smi}),
          flush=True)
    require(np.isfinite(res["scaling"]["rows"][0]["t_mesh_s"]),
            "measure_scaling_shape gave no time")
    res["seconds"] = time.perf_counter() - t0
    log("phase 3h took %.1f s" % res["seconds"])
    return res


# ------------------------------------------------------------ phase 3i
# every device stage forced at the CLI's default --max_num_exons (these
# flags come after DEVICE_ARGS, so they override its)
ALL_STAGES_ARGS = ["--max_num_exons", "10000"] + BRIDGE_SUPPORT_ARGS \
    + LADDER_ARGS
LONG_READ_GENES, LONG_READ_SAMPLES = 2000, 10     # config 4
SMARTSEQ_GENES, SMARTSEQ_CELLS = 1000, 64         # config 5
COHORT_JOBS = 8
GOLDEN_DIR = os.path.join(REPO, "tests", "fixtures", "goldens")
# golden cohorts with no paired-end sample: no bridging phase
SINGLE_END_GOLDENS = ("ont2", "ont_compact2", "pacbio2")
# The golden cohorts as tools/refbuild/compare.py simulates them for the
# upstream binary, built in a subprocess (it imports the JAX package's
# simulator): {name: bams.list}
GOLDEN_BUILD = """import json, os, sys
from tools.refbuild.compare import COHORTS, write_list
made = {}
for name in sorted(COHORTS):
    d = os.path.join(sys.argv[1], name)
    os.makedirs(d)
    made[name] = write_list(d, *COHORTS[name](d))
print(json.dumps(made))
"""
# stage -> (what the card carried, dispatches, kernel (None: plain
# PyTorch), host refusals, solve()'s host clock in s, the kernel's CUDA
# events in s (None: not kept))
STAGE_KEYS = {
    "drain": ("fused_graphs", "fused_dispatches", "drain", "host_graphs",
              "fused_device_time", "fused_kernel_time"),
    "bridge": ("device_bridge_insts", "bridge_dispatches", "bridge",
               "host_bridge_insts", "bridge_device_time",
               "bridge_kernel_time"),
    "support": ("device_support_groups", "support_dispatches", None,
                "host_support_groups", "support_device_time", None),
    "ladder": ("device_ladder_graphs", "ladder_dispatches", "ladder",
               "host_ladder_graphs", "ladder_device_time",
               "ladder_kernel_time")}


def _one_launch_a_dispatch(tag, st, n):
    """Every solver's kernel launched once for each of its dispatches."""
    for stage, (_, disp, kernel, *_) in STAGE_KEYS.items():
        if kernel is not None:
            require(n[kernel] == st.get(disp, 0),
                    "%s: %d %s kernel launches for %d dispatches"
                    % (tag, n[kernel], stage, st.get(disp, 0)))


def _stage_lines(st, n):
    """One line a stage: what the card carried, its dispatches and kernel
    launches, the host's refusals, and the solve() and kernel times."""
    lines = []
    for stage, (done, disp, kernel, host, solve, ev) in STAGE_KEYS.items():
        kt = st.get(ev, 0.0) if ev else None
        lines.append(
            "  %s: %d on the card in %d dispatches, %s kernel launches, %d "
            "refused to the host; solve() %.3f s, kernel events %s"
            % (stage, st.get(done, 0), st.get(disp, 0),
               n[kernel] if kernel else "no (plain PyTorch)",
               st.get(host, 0), st.get(solve, 0.0),
               "%.4f s" % kt if kt is not None else "not kept"))
    return "\n".join(lines)


class _SupportSlots:
    """While active, counts each support pause by (the group spans more
    sample slots than the solver stages, its export reached the card), and
    holds each staged row to the export's gate (native/core.cpp
    GroupRun::support_export): a junction goes to the card only if it
    spans at most the staged slots with non-negative integral weights
    whose sum is exact in f32, so a row holds only such columns, no more
    of them than the export counted, and a refused group's row is
    empty."""

    def __enter__(self):
        import numpy as np

        from aletsch_tpu_torch.meta import native_core
        self._orig = orig = native_core.support_export
        self.seen = {}
        self.bad = []

        def export(gh, row):
            v = orig(gh, row)
            key = (len({bd.sp.sample_id for bd in gh.gv}) > row.shape[0],
                   v > 0)
            self.seen[key] = self.seen.get(key, 0) + 1
            cols = row.any(axis=0)
            if not ((row >= 0).all() and (row == np.floor(row)).all()
                    and (row.astype(np.float64).sum(axis=0) < 2**24).all()
                    and int(cols.sum()) <= max(v, 0)):
                self.bad.append((v, int(cols.sum())))
            return v
        native_core.support_export = export
        return self

    def __exit__(self, *exc):
        from aletsch_tpu_torch.meta import native_core
        native_core.support_export = self._orig


def _golden_cohorts(tmp, env, card):
    """Phase 3i (a): the eight golden cohorts through the port's CLI in
    this process with every stage forced on the card and
    ALETSCH_REF_QUIRKS=1: the sorted meta GTF equal to the upstream
    binary's, one kernel launch a dispatch."""
    t0 = time.perf_counter()
    made = json.loads(subprocess.run(
        [sys.executable, "-c", GOLDEN_BUILD, os.path.join(tmp, "goldens")],
        cwd=REPO, env=env, check=True, timeout=600, capture_output=True,
        text=True).stdout.strip().splitlines()[-1])
    log("the eight golden cohorts built in a subprocess (%.1f s)"
        % (time.perf_counter() - t0))
    totals = {}
    for name, lst in sorted(made.items()):
        out = os.path.join(tmp, "goldens", name, "port")
        os.environ["ALETSCH_REF_QUIRKS"] = "1"
        try:
            wall, st, n = _in_process_run(lst, out, ALL_STAGES_ARGS, True)
        finally:
            os.environ.pop("ALETSCH_REF_QUIRKS", None)
        got = _outputs(out)
        with open(os.path.join(GOLDEN_DIR, name, "ref_meta.gtf"), "rb") as fh:
            golden = fh.read()
        require(sorted(got["meta.gtf"].splitlines(True))
                == sorted(golden.splitlines(True)),
                "golden %s: the port's meta GTF differs from the upstream "
                "binary's" % name)
        tag = "golden %s" % name
        _one_launch_a_dispatch(tag, st, n)
        require(st.get("ladder_agree", 0) == st.get("ladder_total", 0),
                "%s: ladder decisions agree %s of %s"
                % (tag, st.get("ladder_agree"), st.get("ladder_total")))
        if name in SINGLE_END_GOLDENS:
            require(st["device_bridge_insts"] == st["host_bridge_insts"]
                    == st.get("bridge_dispatches", 0) == n["bridge"] == 0,
                    "%s: a single-end cohort reached the bridge: %s"
                    % (tag, st))
        for k in ("device_ladder_graphs", "device_bridge_insts",
                  "device_support_groups", "ladder_dispatches",
                  "bridge_dispatches", "support_dispatches"):
            totals[k] = totals.get(k, 0) + st.get(k, 0)
        log("%s on %s (every stage forced, quirks mode, in process): wall "
            "%.2f s; meta GTF == the upstream binary's (no wall of it in "
            "this call)\n%s" % (tag, card, wall, _stage_lines(st, n)))
    for k, v in totals.items():
        require(v > 0, "the golden cohorts never engaged %s" % k)
    return totals


def _long_read_config(tmp, env, card):
    """Phase 3i (b): config 4, PacBio CCS and ONT samples in turn, with the
    drain (at --max_num_exons 8), bridge, support and ladder forced, in
    trust and in verify mode, against the JAX package's host run."""
    lst = _build_cohort(os.path.join(tmp, "config4"), LONG_READ_GENES,
                        LONG_READ_SAMPLES, env, "long_read")
    out = os.path.join(tmp, "config4_ref")
    ref_wall = _subprocess_wall("aletsch_tpu", lst, out, HOST_ARGS, env)
    ref = _outputs(out)
    runs = []
    for trust in (True, False):
        mode = "trust" if trust else "verify"
        out = os.path.join(tmp, "config4_" + mode)
        wall, st, n = _in_process_run(lst, out, BRIDGE_SUPPORT_ARGS
                                      + LADDER_ARGS, trust)
        _require_same(_outputs(out), ref, "config 4's %s-mode run" % mode)
        tag = "config 4 (%d genes x %d PacBio CCS / ONT samples), %s" % (
            LONG_READ_GENES, LONG_READ_SAMPLES, mode)
        _one_launch_a_dispatch(tag, st, n)
        require(n["drain"] > 0 and st["fused_graphs"] > 0,
                "%s: the drain kernel carried no graph" % tag)
        require(st["fused_trust"] is trust and st["ladder_trust"] is trust,
                "%s: trust %s / %s" % (tag, st["fused_trust"],
                                       st["ladder_trust"]))
        require(st["fused_agree"] == st["fused_total"] > 0,
                "%s: drain agree %d of %d" % (tag, st["fused_agree"],
                                              st["fused_total"]))
        require(st["ladder_agree"] == st["ladder_total"] > 0,
                "%s: ladder decisions agree %d of %d"
                % (tag, st["ladder_agree"], st["ladder_total"]))
        require(st["device_bridge_insts"] == st["host_bridge_insts"]
                == st.get("bridge_dispatches", 0) == n["bridge"] == 0,
                "%s: single-end samples reached the bridge" % tag)
        log("%s on %s, in process: wall %.2f s against the JAX package's "
            "%.2f s (a subprocess, the same call); %d files byte-identical; "
            "drain agree %d of %d, ladder decisions agree %d of %d\n%s"
            % (tag, card, wall, ref_wall, len(ref), st["fused_agree"],
               st["fused_total"], st["ladder_agree"], st["ladder_total"],
               _stage_lines(st, n)))
        runs.append((mode, wall, st, n))
    return {"ref_wall": ref_wall, "runs": runs}


def _smartseq_config(tmp, env, card):
    """Phase 3i (c): config 5, 64 smart-seq cells, with every stage forced
    (trust mode) and at the CLI's defaults (in a temporary directory of its
    own, so 'auto' finds no calibration) beside ALETSCH_DEVICE=0."""
    from aletsch_tpu_torch.ops import crossover
    lst = _build_cohort(os.path.join(tmp, "config5"), SMARTSEQ_GENES,
                        SMARTSEQ_CELLS, env, "smartseq")
    out = os.path.join(tmp, "config5_ref")
    ref_wall = _subprocess_wall("aletsch_tpu", lst, out, HOST_ARGS, env)
    ref = _outputs(out)
    tag = "config 5 (%d smart-seq cells x %d genes)" % (SMARTSEQ_CELLS,
                                                        SMARTSEQ_GENES)
    out = os.path.join(tmp, "config5_forced")
    with _SupportSlots() as slots:
        wall, st, n = _in_process_run(lst, out, BRIDGE_SUPPORT_ARGS
                                      + LADDER_ARGS, True)
    _require_same(_outputs(out), ref, "config 5's forced run")
    _one_launch_a_dispatch(tag, st, n)
    for k in ("fused_graphs", "device_bridge_insts", "device_ladder_graphs"):
        require(st.get(k, 0) > 0, "%s: %s is 0" % (tag, k))
    require(st.get("ladder_agree") == st.get("ladder_total", 0) > 0,
            "%s: ladder decisions agree %s of %s"
            % (tag, st.get("ladder_agree"), st.get("ladder_total")))
    require(not slots.bad, "%s: %d staged support rows break the export's "
            "gate, (exported junctions, columns) %s"
            % (tag, len(slots.bad), slots.bad[:8]))
    require(sum(slots.seen.values()) == st["host_support_groups"]
            + st["device_support_groups"], "%s: support pauses %s against "
            "the stats' %d + %d" % (tag, slots.seen, st["host_support_groups"],
                                    st["device_support_groups"]))
    log("%s forced on %s, in process: wall %.2f s against the JAX package's "
        "%.2f s (a subprocess, the same call); %d files byte-identical; "
        "support groups: host %d, card %d; by (more than the staged sample "
        "slots, exported): %s\n%s"
        % (tag, card, wall, ref_wall, len(ref), st["host_support_groups"],
           st["device_support_groups"], sorted(slots.seen.items()),
           _stage_lines(st, n)))
    res = {"ref_wall": ref_wall, "forced": (wall, st, n)}

    # the defaults, in a temporary directory of its own
    policy_tmp = os.path.join(tmp, "config5_policy_tmp")
    os.makedirs(policy_tmp)
    cuda_env = dict(env, ALETSCH_TORCH_DEVICE="cuda", TMPDIR=policy_tmp)
    cache = os.path.join(policy_tmp, os.path.basename(crossover.cache_path()))
    out = os.path.join(tmp, "config5_default")
    res["wall_auto"], st = _default_run(lst, out, cuda_env)
    _require_same(_outputs(out), ref, "config 5's default run")
    out = os.path.join(tmp, "config5_off")
    res["wall_off"], st_off = _default_run(lst, out,
                                           dict(cuda_env, ALETSCH_DEVICE="0"))
    _require_same(_outputs(out), ref, "config 5's run with ALETSCH_DEVICE=0")
    require("auto" not in st_off and not any(
        _sent(st_off, s) for s in STAGE_COUNTS),
        "ALETSCH_DEVICE=0 asked the policy or reached the card: %s" % st_off)
    auto = st.get("auto") or {"asked": {}, "calibrated": False,
                              "measured_in_s": None}
    cal = None
    if os.path.isfile(cache):
        with open(cache) as fh:
            cal = json.load(fh)
    require((cal is not None) == auto["calibrated"], "%s at the defaults: "
            "calibrated %s, a calibration file %s"
            % (tag, auto["calibrated"], cal is not None))
    res["auto"], res["calibration_s"] = auto, cal and cal["measured_in_s"]
    log("%s at the defaults on %s: wall %.2f s, with ALETSCH_DEVICE=0 "
        "%.2f s, the JAX package's %.2f s; both byte-identical; a "
        "calibration file %s"
        % (tag, card, res["wall_auto"], res["wall_off"], ref_wall,
           "appeared (measured in %.2f s)" % cal["measured_in_s"]
           if cal else "did not appear"))
    for stage in crossover.STAGES:
        asked = auto["asked"].get(stage, {})
        for k, ans in asked.items():
            want = cal is not None and crossover.stage_wins(stage, int(k), cal)
            require(ans == want, "'auto' answered %s for %s at %s instances; "
                    "its fit says %s" % (ans, stage, k, want))
        sub = crossover.stage_calibration(cal, stage) if cal else None
        log("  'auto' %s: break-even %s; asked at %d sizes (%s), yes at %d; "
            "instances sent to the card %d"
            % (stage, sub.get("break_even_B") if sub else None, len(asked),
               "%s to %s" % (min(asked), max(asked)) if asked else "none",
               sum(asked.values()), _sent(st, stage)))
    return res


def protocols_path(tmp, env, card):
    """Phase 3i: the golden cohorts, config 4 and config 5 on the card."""
    t0 = time.perf_counter()
    res = {"goldens": _golden_cohorts(tmp, env, card),
           "config4": _long_read_config(tmp, env, card),
           "config5": _smartseq_config(tmp, env, card)}
    res["seconds"] = time.perf_counter() - t0
    log("phase 3i took %.1f s" % res["seconds"])
    return res


# ------------------------------------------------------------ phase 3j
BENCH_STAGES = ("drain", "bridge", "ladder")


def bench_path(tmp, env, smi):
    """Phase 3j: the port's benchmark, bench_torch.py --config 3 --mode all
    on the 200-gene cohort, one rep, as a subprocess with a temporary
    directory of its own: exit 0, a JSON last line with correct true, one
    kernel launch a dispatch of the drain, bridge and ladder, the trace's
    device records equal to what was queued, an idle share in [0, 1], and
    the card's own name and power limit."""
    t0 = time.perf_counter()
    detail = os.path.join(tmp, "bench_torch_detail.json")
    bench_tmp = os.path.join(tmp, "bench_tmp")
    os.makedirs(bench_tmp)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--config",
         "3", "--mode", "all", "--genes", str(SMALL_GENES), "--reps", "1",
         "--detail", detail], cwd=REPO, capture_output=True, text=True,
        env=dict(env, ALETSCH_TORCH_DEVICE="cuda", TMPDIR=bench_tmp),
        timeout=900)
    require(res.returncode == 0, "bench_torch.py exited %d: %s"
            % (res.returncode, res.stderr[-2000:]))
    last = res.stdout.strip().splitlines()[-1]
    head = json.loads(last)
    require(len(last) < 2000 and head["correct"] is True,
            "bench_torch.py: %s" % last)
    for stage in BENCH_STAGES:
        st = head["stages"][stage]
        require(st["launches"] == st["dispatches"] > 0, "bench_torch.py: %s "
                "kernel launches %s for %s dispatches"
                % (stage, st["launches"], st["dispatches"]))
    with open(detail) as fh:
        trace = json.load(fh)["cells"][0]["trace"]
    require(trace["records"] == trace["counts"]["enqueued"] > 0,
            "bench_torch.py's trace: %d device records for %d queued"
            % (trace["records"], trace["counts"]["enqueued"]))
    require(0.0 <= head["idle_share"] <= 1.0, "bench_torch.py: idle share "
            "%s" % head["idle_share"])
    name, limit = (x.strip() for x in smi.split(",", 1))
    dev = head["device"]
    require(dev["kind"] == name and dev["power_limit"] == limit,
            "bench_torch.py's device %s against nvidia-smi's %s" % (dev, smi))
    secs = time.perf_counter() - t0
    log("phase 3j on %s: bench_torch.py --config 3 --mode all --genes %d "
        "--reps 1 (a subprocess): port %.2f s, reference %.2f s, "
        "vs_baseline %.3f, correct, launches == dispatches %s, %d device "
        "records for %d queued, idle share %.4f, import torch %.2f s; "
        "%.1f s\n%s" % (smi, SMALL_GENES, head["wall_s"], head["ref_wall_s"],
                        head["vs_baseline"], {s: head["stages"][s]["launches"]
                                              for s in BENCH_STAGES},
                        trace["records"], trace["counts"]["enqueued"],
                        head["idle_share"], head["setup_s"]["import_torch"],
                        secs, last))
    return {"headline": head, "seconds": secs}


def new_phases(phases, smi, card, genes=SMALL_GENES, samples=SAMPLES):
    """--phases: phases 3i and 3j if named, on their own cohorts; then, if
    any of 3e to 3h is named, one reference and one forced port run on the
    small cohort, and those phases on it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    with tempfile.TemporaryDirectory(prefix="aletsch_chip_smoke_") as tmp:
        if "3i" in phases:
            protocols_path(tmp, env, card)
        if "3j" in phases:
            bench_path(tmp, env, smi)
        if not set(phases) - {"3i", "3j"}:
            return
        lst = _build_cohort(os.path.join(tmp, "cohort"), genes, samples, env)
        out = os.path.join(tmp, "reference0")
        wall = _subprocess_wall("aletsch_tpu", lst, out, HOST_ARGS, env)
        ref = _outputs(out)
        out = os.path.join(tmp, "port1")
        port_wall = _subprocess_wall("aletsch_tpu_torch", lst, out,
                                     DEVICE_ARGS,
                                     dict(env, ALETSCH_TORCH_DEVICE="cuda"))
        _require_same(_outputs(out), ref, "the port run")
        log("%d-gene cohort: reference wall %.2f s, forced port wall %.2f s, "
            "byte-identical" % (genes, wall, port_wall))
        if "3e" in phases:
            scoring_path(tmp, os.path.join(out, "gtf"), samples, env)
        if "3f" in phases:
            jobs_path(tmp, lst, ref, env)
        if "3g" in phases:
            trace_path(tmp, lst, ref, env)
        if "3h" in phases:
            mesh_path(tmp, lst, ref, env, smi)


NEW_PHASES = ("3e", "3f", "3g", "3h", "3i", "3j")


def main(argv=None):
    import torch
    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    phases = None
    if len(argv) == 2 and argv[0] == "--phases":
        phases = argv[1].split(",")
    if not (argv in ([], ["--kernels-only"]) or phases
            and set(phases) <= set(NEW_PHASES)):
        print("usage: python3 chip_smoke.py [--kernels-only | --phases "
              "%s]" % ",".join(NEW_PHASES), file=sys.stderr)
        return 2
    kernels_only = argv == ["--kernels-only"]
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "aletsch_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.environ["ALETSCH_TORCH_DEVICE"] = "cuda"
    dev = torch.device("cuda")
    try:
        smi, name = environment()
        if phases:
            new_phases(phases, smi, name)
            log("--phases %s: done in %.1f s; no result line"
                % (",".join(phases), time.perf_counter() - t_start))
            return 0
        log("phase 1 took %.1f s" % (time.perf_counter() - t_start))
        t0 = time.perf_counter()
        err, times = kernel_vs_plain(dev)
        bn_err, pos_launches, bn_times = bottleneck_vs_plain(dev)
        forms = torch_forms_vs_oracles(dev)
        new_forms_vs_oracles(dev)
        policy_measurements(smi)
        wave_step_vs_oracle(dev)
        log("phases 2 to 2e took %.1f s" % (time.perf_counter() - t0))
        if kernels_only:
            log("--kernels-only: stopping before the main path")
            return 0
        t0 = time.perf_counter()
        res = main_path(forms, smi, name)
        log("phases 3 to 3j took %.1f s" % (time.perf_counter() - t0))
        prof = res["profiled"]
        st, launches = prof["stats"], prof["stats"]["drain_launches"]
        log("device stats: %s" % json.dumps(st, sort_keys=True))
        require(st["bottleneck_launches"] == 0, "the fused path launched the "
                "bottleneck kernel %d times" % st["bottleneck_launches"])
        require(st.get("fused_graphs", 0) > 0, "the drain never engaged")
        require(launches >= st["fused_dispatches"] > 0,
                "kernel launches %d < dispatches %d"
                % (launches, st["fused_dispatches"]))
        require(st["fused_trust"] is True, "trust mode is off on the card")
        require(st["fused_agree"] == st["fused_total"] > 0,
                "device paths disagree with the host drain (%d of %d)"
                % (st["fused_agree"], st["fused_total"]))
        _profiled_run("port", name, prof, "drain", launches)
        log("solve() host clock %.3f s over %d launches, %d graphs; "
            "kernel events %.2f ms, the host blocked on the card %.3f s"
            % (st["fused_device_time"], launches, st["fused_graphs"],
               st["fused_kernel_time"] * 1e3, st["fused_sync_time"]))
        step = res["step"]
        sst = step["stats"]
        step_launches = sst["bottleneck_launches"]
        log("step-mode device stats: %s" % json.dumps(sst, sort_keys=True))
        require(sst["drain_launches"] == 0, "the step path launched the "
                "drain kernel %d times" % sst["drain_launches"])
        require(sst["device_steps"] > 0, "step mode consumed no device row")
        require(step_launches >= sst["dispatches"] > 0,
                "bottleneck launches %d < dispatches %d"
                % (step_launches, sst["dispatches"]))
        _profiled_run("step-mode", name, step, "bottleneck", step_launches)
        log("step mode: %d dispatches, %d device rows, %d host graphs; "
            "solve() host clock %.3f s" % (sst["dispatches"],
                                          sst["device_steps"],
                                          sst["host_graphs"],
                                          sst["device_time"]))
        new = res["new"]
        for tag, wall, nst, n in new["runs"]:
            log("new path run (%s) on %s: wall %.2f s; drain launches %d, "
                "ladder kernel launches %d, bridge kernel launches %d; "
                "device stats: %s"
                % (tag, name, wall, n["drain"], n["ladder"], n["bridge"],
                   json.dumps(nst, sort_keys=True)))
            for form, unit in (("bridge", "instances"), ("support", "groups"),
                               ("ladder", "graphs")):
                d = nst.get(form + "_dispatches", 0)
                if d:
                    secs = nst[form + "_device_time"]
                    log("  %s: %d dispatches, %.2f %s a dispatch, solve() "
                        "host clock %.3f s (%.3f ms a dispatch, %.1f %% of "
                        "the wall)%s"
                        % (form, d, nst["%s_%s" % (form, unit)] / d, unit,
                           secs, secs / d * 1e3, 100.0 * secs / wall,
                           "; %d events in the longest graphs, %.1f a "
                           "dispatch; %d decisions, agree %d of %d; the "
                           "kernel's device time %.3f s in all (%.4f ms a "
                           "launch; CUDA events around each launch)"
                           % (nst["ladder_iterations"],
                              nst["ladder_iterations"] / d,
                              nst["ladder_decisions"], nst["ladder_agree"],
                              nst["ladder_total"], nst["ladder_kernel_time"],
                              nst["ladder_kernel_time"] / d * 1e3)
                           if form == "ladder" else
                           "; launch to completion %.3f s in all (%.4f ms "
                           "a launch; CUDA events around each launch, so "
                           "the card's wait for the launch is in it)"
                           % (nst["bridge_kernel_time"],
                              nst["bridge_kernel_time"] / d * 1e3)
                           if form == "bridge" else ""))
        sc, jobs = res["scoring"], res["jobs"]
        log("new phases on %s: scores CSV byte-identical over %d feature "
            "rows; --jobs 2 wall %.2f s on %d genes, drain launches per "
            "worker %s" % (name, sc["csv_rows"], jobs["wall"], SMALL_GENES,
                           jobs["worker_launches"]))
        ms = res["mesh"]
        log("phase 3h on %s: --jax_dist_launch 2 wall %.2f s, drain "
            "launches per rank %s; dryrun_multichip %.2f s; the sharded "
            "step's host clock (ms) by shards on one card %s"
            % (name, ms["dist_wall"], ms["rank_launches"], ms["dryrun_s"],
               {k: round(v, 3) for k, v in ms["step_ms"].items()}))
        pr = res["protocols"]
        c4, c5 = pr["config4"], pr["config5"]
        log("phase 3i on %s: the eight golden cohorts == the upstream "
            "binary's meta GTF with every stage forced (%s); config 4 walls "
            "%s s (trust, verify) against the JAX package's %.2f s; config 5 "
            "forced %.2f s, at the defaults %.2f s (calibration %s), with "
            "ALETSCH_DEVICE=0 %.2f s, against the JAX package's %.2f s; %.1f s"
            % (name, pr["goldens"], [round(r[1], 2) for r in c4["runs"]],
               c4["ref_wall"], c5["forced"][0], c5["wall_auto"],
               "%.2f s" % c5["calibration_s"] if c5["calibration_s"]
               else "none", c5["wall_off"], c5["ref_wall"], pr["seconds"]))
    except SmokeFailure as e:
        print("chip_smoke: FAIL: %s" % e, file=sys.stderr)
        return 1
    log("the whole script took %.1f s" % (time.perf_counter() - t_start))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "drain",
        "route": "cuda",
        "source": "aletsch_tpu_torch/csrc/drain.cu",
        "replaces": "aletsch_tpu/ops/pallas_drain.py:186",
        "launches": launches,
        "max_abs_err": err,
        "ms": times[1]["device"],
        "plain_ms": times[1]["plain"],
        "bound_ms": times[1]["bound"],
        "bound_by": times[1]["bound_by"],
        "library_ms": None}, {
        "name": "bottleneck (NEG form)",
        "route": "cuda",
        "source": "aletsch_tpu_torch/csrc/bottleneck.cu",
        "replaces": "aletsch_tpu/ops/pallas_kernels.py:112",
        "launches": step_launches,
        "max_abs_err": bn_err,
        "ms": bn_times["neg", 1]["device"],
        "plain_ms": bn_times["neg", 1]["plain"],
        "bound_ms": bn_times["neg", 1]["bound"],
        "bound_by": bn_times["neg", 1]["bound_by"],
        "library_ms": None}, {
        "name": "bottleneck (positive form)",
        "route": "cuda",
        "source": "aletsch_tpu_torch/csrc/bottleneck.cu",
        "replaces": "aletsch_tpu/ops/pallas_kernels.py:61",
        "launches": pos_launches,
        "max_abs_err": bn_err,
        "ms": bn_times["pos", 64]["device"],
        "plain_ms": bn_times["pos", 64]["plain"],
        "bound_ms": bn_times["pos", 64]["bound"],
        "bound_by": bn_times["pos", 64]["bound_by"],
        "library_ms": None}, {
        "name": "ladder",
        "route": "cuda",
        "source": "aletsch_tpu_torch/csrc/ladder.cu",
        "replaces": "aletsch_tpu/ops/ladder_kernel.py:772",
        "launches": new["runs"][0][3]["ladder"],
        "max_abs_err": forms["ladder_err"],
        "ms": forms["ladder_kernel"][3]["device"],
        "plain_ms": forms["ladder_kernel"][3]["plain"],
        "bound_ms": forms["ladder_kernel"][3]["bound"],
        "bound_by": forms["ladder_kernel"][3]["bound_by"],
        "library_ms": None}, {
        "name": "bridge top-K",
        "route": "cuda",
        "source": "aletsch_tpu_torch/csrc/bridge.cu",
        "replaces": "aletsch_tpu/ops/bridge_topk.py:54",
        "launches": new["runs"][0][3]["bridge"],
        "max_abs_err": forms["bridge_err"],
        "ms": forms["bridge_kernel"][37]["device"],
        "plain_ms": forms["bridge_kernel"][37]["plain"],
        "bound_ms": forms["bridge_kernel"][37]["bound"],
        "bound_by": forms["bridge_kernel"][37]["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    code = main()
    # leave without the interpreter's teardown: with CUPTI released after
    # each capture (TEARDOWN_CUPTI above), the CUDA runtime's own teardown
    # at exit can block (seen once on the H100, after every check had
    # passed); every subprocess has ended by now
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
