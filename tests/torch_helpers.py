"""Shared by the port's tests: an environment in which some modules cannot
be imported, in the process and in every process it spawns (workers
inherit PYTHONPATH, and with it the sitecustomize shim); a run's output
bytes; and the JAX package's native library loaded again where its loader
gave up on it in a race (done once when a test worker imports this)."""

import os
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def blocked_env(shim_dir, blocked=("jax", "aletsch_tpu"), **extra):
    """os.environ with the CPU device, one torch thread, and a
    sitecustomize.py in shim_dir, first on PYTHONPATH, that makes each
    module in `blocked` unimportable."""
    os.makedirs(shim_dir, exist_ok=True)
    with open(os.path.join(shim_dir, "sitecustomize.py"), "w") as fh:
        fh.write("import sys\nfor _m in %r:\n    sys.modules[_m] = None\n"
                 % (tuple(blocked),))
    env = dict(os.environ, ALETSCH_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(shim_dir), REPO]))
    for var in ("ALETSCH_DEVICE", "ALETSCH_DEVICE_GREEDY"):
        env.pop(var, None)
    env.update(extra)
    return env


def output_bytes(out_gtf, out_dir):
    """{name: bytes} of a run's combined GTF and every file of its
    per-sample directory."""
    files = {"meta.gtf": open(out_gtf, "rb").read()}
    for f in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, f), "rb") as fh:
            files[f] = fh.read()
    return files


def _reload_failed_reference_native(wait_s=60.0):
    """Try the JAX package's native library again in this process if its
    loader (aletsch_tpu/io/bam_native.py) gave up on it.  That loader keeps
    a failed load for the life of the process, and it fails when it opens
    native/libabam.so while another process is still linking that file in
    place: test workers collecting at once race so
    (tests/test_torch_native_build.py).  While the file is there but does
    not load, another process is still linking it: wait for it."""
    from aletsch_tpu.io import bam_native as ref
    deadline = time.monotonic() + wait_s
    while ref._LIB is None and ref._LIB_TRIED \
            and os.path.exists(ref._SO_PATH) and time.monotonic() < deadline:
        ref._LIB_TRIED = False
        if ref._load_lib() is None:
            time.sleep(0.5)


def load_reference_native():
    """Make the JAX package's native library loaded in this process, as the
    port's is, before a test compares the two packages' views of it.
    Returns whether it is loaded."""
    from aletsch_tpu.io import bam_native as ref
    _reload_failed_reference_native()
    return ref._load_lib() is not None


# Every test worker imports this module while it collects, after its own
# first load of the JAX package's library (tests/test_batched_sweeps.py
# asks at import) and, in all likelihood, after every other worker's link
# of it: a load that failed in the race is made again here, so that the
# tests of this worker, which run after collection, find the library.
_reload_failed_reference_native()
