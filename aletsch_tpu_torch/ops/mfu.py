"""Speed-of-light accounting for the device kernels and solvers.

Counterpart of aletsch_tpu/ops/mfu.py.  For each production device
dispatch this module carries an analytic model of operations and memory
bytes, measures a warm dispatch, and reports the achieved GFLOP/s and GB/s
against the card's peaks — so "the device loses" can be told apart from
"the kernel is mis-tuned" in numbers.

Models (all counts are per dispatch; the reference's, unchanged):

- greedy_fused (ops/greedy_fused.py, [B,V,V] f64): the drain is a loop of
  r rounds (r = max paths per graph + 1).  Each round runs a V-step forward
  bottleneck DP (min+max over [B,V] per step ~ 2 B V^2), a V-step
  backtrace (~4 B V^2 gather/compare), and the bottleneck subtraction
  (~4 B V^2), so flops ~= 10 B V^2 r; the [B,V,V] f64 state is read and
  written every round: bytes ~= 20 B V^2 r.
- bridge_topk (ops/bridge_topk.py, [B,V,E] i32, K=10, S=5): V steps of
  stack-insert (~3 B E K S) plus a stable lexicographic sort of N = E K
  candidates on S+2 keys (~B N log2(N) (S+2) compares): int ops
  ~= V B (3 E K S + N log2(N) (S+2)); bytes ~= V B (E K S reads + K (S+4)
  writes) * 4.
- support_reduce (ops/support.py, [B,NS,J] f32): one sample-axis sum:
  flops = B NS J, bytes = 4 B NS J reads + 4 B J writes.
- bottleneck (ops/bottleneck.py over csrc/bottleneck.cu, [B,V,V] f32): V DP
  steps of min/max: flops ~= 3 B V^2; bytes ~= 4 B V^2 (W read once).

Peaks: NVIDIA's public data-sheet figures for the H100 SXM5 at its full
power limit of 700 W (a card set below it runs slower under load, so
measure_all reports the limit beside the card's name).  The drain runs in
native f64 on the card, so its share is stated against the f64 vector
peak; every other entry against the f32 vector peak.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..device import device as port_device

# NVIDIA H100 SXM5 data sheet: HBM3 GB/s, dense bf16 tensor-core TFLOP/s,
# f32 and f64 TFLOP/s outside the tensor cores (a fused multiply-add counted
# as two).  Keyed by the prefix of torch.cuda.get_device_name()
CHIP_PEAKS = {
    "NVIDIA H100": {"hbm_gbps": 3350.0, "tensor_bf16_tflops": 989.0,
                    "vector_f32_tflops": 67.0, "vector_f64_tflops": 34.0},
    # the CPU device of the tests: no meaningful peaks
    "cpu": None,
}


def device_kind(device=None):
    """torch.cuda.get_device_name() of the port's CUDA device, else "cpu"."""
    dev = port_device() if device is None else torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit():
    """The card's power limit as nvidia-smi prints it ("700.00 W"), or
    "not read" where nvidia-smi cannot be run."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def chip_peaks(kind=None):
    kind = kind or device_kind()
    for k, v in CHIP_PEAKS.items():
        if kind.lower().startswith(k.lower()):
            return v
    return None


# ---------------------------------------------------------------- models

def model_greedy_fused(B, V, rounds):
    flops = 10.0 * B * V * V * rounds
    bytes_ = 20.0 * B * V * V * rounds
    return flops, bytes_


def model_bridge_topk(B, V, E, K, S):
    N = E * K
    sort_ops = N * np.log2(max(N, 2)) * (S + 2)
    flops = V * B * (3.0 * E * K * S + sort_ops)
    bytes_ = V * B * (E * K * S + K * (S + 4)) * 4.0
    return flops, bytes_


def model_support(B, NS, J):
    return float(B * NS * J), 4.0 * (B * NS * J + B * J)


def model_bottleneck(B, V):
    return 3.0 * B * V * V, 4.0 * B * V * V


# ------------------------------------------------------------- analysis

def _entry(name, dispatch_s, flops, bytes_, peaks, note="", f64=False):
    """One dispatch against the peaks.  f64: the work runs in f64 (the
    drain), so its share is of the f64 vector peak."""
    gflops = flops / dispatch_s / 1e9 if dispatch_s > 0 else 0.0
    gbps = bytes_ / dispatch_s / 1e9 if dispatch_s > 0 else 0.0
    ent = {
        "dispatch_s": round(dispatch_s, 6),
        "model_mflops": round(flops / 1e6, 2),
        "model_mbytes": round(bytes_ / 1e6, 2),
        "achieved_gflops": round(gflops, 3),
        "achieved_gbps": round(gbps, 3),
    }
    if peaks:
        vec = "vector_f64_tflops" if f64 else "vector_f32_tflops"
        ent["vector_peak"] = vec
        ent["pct_of_hbm_peak"] = round(100.0 * gbps / peaks["hbm_gbps"], 4)
        ent["pct_of_vector_peak"] = round(
            100.0 * gflops / (peaks[vec] * 1e3), 4)
        # compute-bound needs >~50% of a peak; bandwidth-bound likewise;
        # far below both = latency/serialization-bound
        if ent["pct_of_hbm_peak"] < 1.0 and ent["pct_of_vector_peak"] < 1.0:
            ent["bound"] = "latency/serialization"
        elif ent["pct_of_hbm_peak"] >= ent["pct_of_vector_peak"]:
            ent["bound"] = "bandwidth"
        else:
            ent["bound"] = "compute"
    if note:
        ent["note"] = note
    return ent


def _median_s(fn, reps):
    """Median host clock of fn(), which ends with its results on the host,
    after one warm call."""
    import time
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def measure_all(reps=3, device=None):
    """Measure a warm dispatch (host clock: copies in, launch, copies out)
    of every production device solver on the port's device and report it
    against the card's peaks (null on the CPU device of the tests)."""
    from . import crossover
    from .bottleneck import bottleneck_from_source
    from .bridge_topk import DeviceBridge, K, S
    from .greedy_fused import DeviceGreedyFused
    from .support import DeviceSupport

    dev = port_device() if device is None else torch.device(device)
    kind = device_kind(dev)
    peaks = chip_peaks(kind)
    out = {"device_kind": kind,
           "power_limit": power_limit() if dev.type == "cuda" else None,
           "peaks": peaks, "kernels": {}}

    # fused greedy drain at the production shape
    B, V = 64, 64
    W, P, sink, scal = crossover.synth_batch(B, V)
    fd = DeviceGreedyFused(batch=B, maxv=V, device=dev)
    fd.W[:], fd.P[:], fd.sink[:], fd.scal[:] = W, P, sink, scal
    rounds = int(np.max(fd.solve(B)[2])) + 1
    fl, by = model_greedy_fused(B, V, rounds)
    out["kernels"]["greedy_fused"] = _entry(
        "greedy_fused", _median_s(lambda: fd.solve(B), reps), fl, by, peaks,
        note="f64 on the device (%s), share stated of the f64 vector peak; "
             "%d drain rounds" % (fd.stats["fused_form"], rounds), f64=True)

    # bridge top-K DP
    bd = DeviceBridge(device=dev)
    rng = np.random.default_rng(5)
    for b in range(bd.batch):
        n = 48
        for v in range(1, n):
            ne = min(v, 3)
            preds = rng.choice(v, size=ne, replace=False)
            for e, u in enumerate(preds):
                bd.P[b, v, e] = u
                bd.Wt[b, v, e] = int(rng.integers(1, 1000))
        bd.Lv[b, :n] = rng.integers(50, 500, size=n)
        bd.tgt[b, :4] = rng.choice(np.arange(1, n), size=4, replace=False)
    fl, by = model_bridge_topk(bd.batch, bd.maxv, bd.maxe, K, S)
    out["kernels"]["bridge_topk"] = _entry(
        "bridge_topk", _median_s(lambda: bd.solve(bd.batch), reps), fl, by,
        peaks, note="i32 stack DP + stable lex sort; counts are int ops")

    # support reduce
    sd = DeviceSupport(device=dev)
    sd.jw[:] = rng.random(sd.jw.shape, dtype=np.float32)
    fl, by = model_support(sd.batch, sd.maxs, sd.maxj)
    out["kernels"]["support_reduce"] = _entry(
        "support_reduce", _median_s(lambda: sd.solve(sd.batch), reps), fl,
        by, peaks)

    # single-source bottleneck kernel, positive form
    Wf = np.zeros((B, V, V), dtype=np.float32)
    for b in range(B):
        for j in range(1, V):
            for u in rng.choice(j, size=min(j, 3), replace=False):
                Wf[b, u, j] = float(rng.integers(1, 1000))
    fl, by = model_bottleneck(B, V)
    out["kernels"]["bottleneck"] = _entry(
        "bottleneck",
        _median_s(lambda: bottleneck_from_source(Wf, device=dev), reps),
        fl, by, peaks)

    # one-paragraph roofline verdict, from this run's numbers
    ks = {k: v for k, v in out["kernels"].items() if "bound" in v}
    if peaks and ks:
        card = "%s, %s" % (kind, out["power_limit"])
        out["analysis"] = (
            "Measured on %s: " % card
            + "; ".join(
                "%s %.3f ms a dispatch, %.4f %% of the HBM peak and %.4f %% "
                "of the %s peak (%s-bound)"
                % (k, v["dispatch_s"] * 1e3, v["pct_of_hbm_peak"],
                   v["pct_of_vector_peak"],
                   "f64" if "f64" in v["vector_peak"] else "f32", v["bound"])
                for k, v in ks.items())
            + ".  A dispatch here is the host clock of solve(): copies in, "
              "launch, sync, copies out.  Where every entry is "
              "latency/serialization-bound, the work of a dispatch is orders "
              "of magnitude below what either peak needs, and device versus "
              "host is decided by the amortization model alone "
              "(ops/crossover.py: a + b*B against the native host's c*B).")
    return out
