"""Shared by the port's tests that spawn processes: an environment in which
some modules cannot be imported, in the process and in every process it
spawns (workers inherit PYTHONPATH, and with it the sitecustomize shim)."""

import os

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
