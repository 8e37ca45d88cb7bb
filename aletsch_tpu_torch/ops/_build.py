"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under aletsch_tpu_torch/csrc/ have a plain C interface, so nvcc
builds them in seconds without PyTorch's headers.  Each source compiles to
an object in its own nvcc process, all started together, and one more nvcc
links them.  The library goes to <repo>/build/aletsch_tpu_torch/, named by
a hash of all the sources and the flags, and is built on first use; a
failed build raises.  What ptxas reports for each kernel (registers, shared
memory, spills) is kept beside the library, see ptxas_report.  Nothing here
runs at import time: the CPU tests import every module on a machine without
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("drain.cu", "bottleneck.cu", "ladder.cu", "bridge.cu")
# headers the sources include: in the hash, not compiled alone
HEADERS = ("ladder_machine.cuh", "ladder_block.cuh", "bridge_machine.cuh",
           "team.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "aletsch_tpu_torch")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# flags of one source beside NVCC_FLAGS: the ladder's f64 arithmetic must
# not contract a product and a sum into a fused multiply-add
SOURCE_FLAGS = {"ladder.cu": ("-fmad=false",)}

# aletsch_ladder_f64's arguments but the stream: the 17 inputs, B and the
# shape, maxiter, the 13 outputs and the event counts, the inputs'
# per-graph strides (ladder_host.cpp's aletsch_ladder_host takes the same,
# then the threads of its block)
LADDER_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 15)
# aletsch_bridge_topk's arguments but the stream: P, Wt, Lv, tgt, then n,
# V, E, T, the inputs' row strides, then ostk, par, pix
# (aletsch_bridge_topk_prof takes the profile's pointer next, and
# bridge_host.cpp's aletsch_bridge_host the same, then its lanes)
BRIDGE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p] * 3

_LIB = None


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def library_path():
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        flags = " ".join(SOURCE_FLAGS.get(name, ()))
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + flags.encode() + b"\0"
                     + fh.read())
    return os.path.join(BUILD_DIR, "libaletsch_kernels_%s.so"
                        % h.hexdigest()[:16])


def ptxas_report():
    """What ptxas printed when the current library was built (one entry
    per kernel instance: registers, shared memory, spills); '' when the
    library has not been built."""
    path = library_path() + ".ptxas.txt"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def _check(cmd, returncode, stderr):
    if returncode != 0:
        raise RuntimeError("nvcc failed (%d): %s\n%s" % (
            returncode, " ".join(cmd), stderr[-4000:]))


def build():
    """Compile the kernels if this source hash has no library yet; returns
    (path, seconds spent compiling, 0.0 when it was already built)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
                   "-o", obj, os.path.join(CSRC, name)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compile before reporting the first failure
        errs = [proc.communicate()[1] for _, _, proc in jobs]
        for (cmd, _, proc), err in zip(jobs, errs):
            _check(cmd, proc.returncode, err)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", "-o", lib, *[o for _, o, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, res.returncode, res.stderr)
        with open(os.path.join(tmp, "ptxas.txt"), "w") as fh:
            fh.write("".join(errs))
        os.replace(fh.name, out + ".ptxas.txt")
        os.replace(lib, out)        # atomic: concurrent builds agree
    return out, time.perf_counter() - t0


def load_library():
    """The kernels' ctypes library, built on first use."""
    global _LIB
    if _LIB is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("aletsch_drain_f64", "aletsch_drain_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, p, i, i, i, p, p, p, p]
            fn.restype = ctypes.c_int
        for name in ("aletsch_bottleneck_neg", "aletsch_bottleneck_pos"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i, i, p, p]
            fn.restype = ctypes.c_int
        lib.aletsch_ladder_f64.argtypes = LADDER_ARGTYPES + [p]
        lib.aletsch_ladder_f64.restype = ctypes.c_int
        lib.aletsch_ladder_f64_prof.argtypes = LADDER_ARGTYPES + [p, p]
        lib.aletsch_ladder_f64_prof.restype = ctypes.c_int
        lib.aletsch_bridge_topk.argtypes = BRIDGE_ARGTYPES + [p]
        lib.aletsch_bridge_topk.restype = ctypes.c_int
        lib.aletsch_bridge_topk_prof.argtypes = BRIDGE_ARGTYPES + [p, p]
        lib.aletsch_bridge_topk_prof.restype = ctypes.c_int
        _LIB = lib
    return _LIB
