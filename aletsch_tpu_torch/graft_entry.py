"""Entry points of the batched wave step: one device, and the multi-device
dry run.

Counterpart of __graft_entry__.py at the repository root, which belongs to
the JAX package.  entry() gives the step and example arguments on the
port's device; dryrun_multichip(n) splits the step over an n-device
('data', 'sample') mesh of the process-local devices (parallel/mesh.py),
runs one wave of real tensors through it, and then the production
pipeline with every device stage on, whose wave batches split over the
same devices (ops/meshing.py).
"""

import os

from .device import device as port_device
from .parallel.mesh import batch_from_numpy, example_batch, step


def entry(device=None):
    """The batched assembly step and example arguments on the port's
    device (or the one given): step(*args) runs one wave."""
    dev = port_device() if device is None else device
    return step, batch_from_numpy(*example_batch(B=8, V=32), dev)


def _real_wave_tensors(B, V, S, P_, Ns, J):
    """Simulate a 2-sample cohort, run the real pipeline, and capture the
    first region wave's groups into the mesh-step batch
    (parallel/wave_extract.py).  Raises if the capture degenerates (no
    groups, or no multi-sample group reached the support tensor)."""
    import shutil
    import tempfile

    from aletsch_tpu_torch.config import default_params
    from aletsch_tpu_torch.parallel.wave_extract import capture_cohort_tensors
    from aletsch_tpu_torch.sim import simulate_sample

    tmp = tempfile.mkdtemp(prefix="aletsch_dryrun_")
    try:
        b0 = os.path.join(tmp, "s0.bam")
        b1 = os.path.join(tmp, "s1.bam")
        simulate_sample(b0, seed=41)
        simulate_sample(b1, seed=42)
        lst = os.path.join(tmp, "bams.list")
        with open(lst, "w") as fh:
            fh.write("%s %s.bai paired_end\n%s %s.bai paired_end\n"
                     % (b0, b0, b1, b1))
        gtf = os.path.join(tmp, "gtf")
        os.makedirs(gtf)
        params = default_params()
        for p in params:
            p.input_bam_list = lst
            p.output_gtf_file = os.path.join(tmp, "meta.gtf")
            p.output_gtf_dir = gtf
            p.verbose = 0
        tensors, info = capture_cohort_tensors(params, B=B, V=V, S=S,
                                               P_=P_, Ns=Ns, J=J)
        if info["groups"] < 1:
            raise AssertionError("dryrun capture produced no groups")
        if info["samples"] < 2 or info["junctions"] < 1:
            raise AssertionError(
                "dryrun capture has no cross-sample junction support: %r"
                % (info,))
        return tensors
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun_multichip(n_devices: int):
    """Split the full batched step over an n-device ('data', 'sample') mesh
    of the process-local devices and run one wave on REAL tensors
    extracted from a simulated 2-sample cohort (parallel/wave_extract.py).
    Asserts that the sharded outputs equal the single-device outputs and
    the numpy host oracle: exactly for the order-free outputs (min-max
    bottleneck DP, segment max, integral similarity counts, 2-sample
    support sums), to 1e-6 for the coverage stats, whose sums depend on
    their order.  Then the production pipeline with every device stage on
    (_dryrun_incubator_mesh).  Raises on mismatch."""
    import numpy as np

    from .parallel.mesh import build_sharded_step, make_mesh, \
        outputs_to_numpy
    from .parallel.wave_extract import host_oracle

    mesh = make_mesh(n_devices)
    d = mesh.shape["data"]
    s = mesh.shape["sample"]
    B = max(8, d * 4)
    B -= B % d
    Ns = max(2, s)
    Ns -= Ns % s
    tensors = _real_wave_tensors(B=B, V=32, S=16, P_=64, Ns=Ns, J=16)

    want = host_oracle(*tensors)
    args = batch_from_numpy(*tensors, mesh.devices[0][0])
    single = outputs_to_numpy(step(*args))
    sharded = outputs_to_numpy(build_sharded_step(mesh)(*args))
    names = ("bottleneck", "ave", "dev", "mx", "sim", "support")
    exact = {"bottleneck", "mx", "sim", "support"}
    for name, o, g1, g2 in zip(names, want, single, sharded):
        if name in exact:
            if not np.array_equal(g1, g2):
                raise AssertionError(
                    "sharded %s != single-device" % name)
            if not np.array_equal(g2, o):
                raise AssertionError("sharded %s != host oracle" % name)
        else:
            if not np.allclose(g1, g2, rtol=1e-6, atol=1e-6):
                raise AssertionError(
                    "sharded %s !~ single-device" % name)
            if not np.allclose(g2, o, rtol=1e-6, atol=1e-6):
                raise AssertionError("sharded %s !~ host oracle" % name)

    _dryrun_incubator_mesh(n_devices)
    return None


def _dryrun_incubator_mesh(n_devices):
    """Run the PRODUCTION pipeline end to end with every device stage
    forced on (fused greedy drain, bridge top-K, support reduce, ladder):
    the incubator's live batches split over the process-local devices
    (ops/meshing.py).  Assert byte-identical GTFs against the host path
    and, over n > 1 devices, the scaling-shape evidence (dispatches split,
    bytes over the mesh)."""
    import shutil
    import tempfile

    from .config import default_params
    from .meta import device_wave
    from .meta.incubator import Incubator
    from .sim import simulate_adversarial_sample

    device_wave.require_native()
    tmp = tempfile.mkdtemp(prefix="aletsch_dryrun2_")
    try:
        b0 = os.path.join(tmp, "s0.bam")
        b1 = os.path.join(tmp, "s1.bam")
        simulate_adversarial_sample(b0, seed=31, n_loci=6)
        simulate_adversarial_sample(b1, seed=32, n_loci=6)
        lst = os.path.join(tmp, "bams.list")
        with open(lst, "w") as fh:
            fh.write("%s %s.bai paired_end\n%s %s.bai paired_end\n"
                     % (b0, b0, b1, b1))

        def run(sub, on):
            out = os.path.join(tmp, sub)
            os.makedirs(os.path.join(out, "gtf"))
            params = default_params()
            for p in params:
                p.input_bam_list = lst
                p.output_gtf_file = os.path.join(out, "meta.gtf")
                p.output_gtf_dir = os.path.join(out, "gtf")
                p.verbose = 0
                p.max_num_exons = 8
                stage = "on" if on else "off"
                p.device_greedy = stage
                p.device_bridge = stage
                p.device_support = stage
                p.device_ladder = stage
                p.device_similarity = "off"
                if on:
                    p.device_min_vertices = 2
                    p.device_min_groups = 0
            Incubator(params).resolve()
            with open(os.path.join(out, "meta.gtf"), "rb") as fh:
                return fh.read()

        off = run("off", False)
        d0 = device_wave.device_stats()
        on = run("on", True)
        d1 = device_wave.device_stats()
        if on != off:
            raise AssertionError(
                "mesh-sharded incubator wave diverged from host bytes")
        if n_devices > 1:
            if d1.get("mesh_devices") != n_devices:
                raise AssertionError(
                    "wave batches not sharded over %d devices: %r"
                    % (n_devices, {k: d1.get(k) for k in
                                   ("mesh_devices", "mesh_dispatches")}))
            md = d1.get("mesh_dispatches", 0) - d0.get("mesh_dispatches", 0)
            bi = d1.get("mesh_bytes_in", 0) - d0.get("mesh_bytes_in", 0)
            bo = d1.get("mesh_bytes_out", 0) - d0.get("mesh_bytes_out", 0)
            if md < 1 or bi <= 0 or bo <= 0:
                raise AssertionError(
                    "no live batches moved over the mesh: dispatches=%d "
                    "bytes_in=%d bytes_out=%d" % (md, bi, bo))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
    from .ops.meshing import _local_devices
    dryrun_multichip(len(_local_devices(port_device())))
    print("dryrun ok")
