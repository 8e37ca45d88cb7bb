"""Scaling-efficiency measurement for the sharded batched step.

Counterpart of aletsch_tpu/parallel/scaling.py.  Measures bundles/s of the
assembly wave (parallel/mesh.py) at increasing mesh sizes (weak scaling:
the batch grows with the device count), reporting efficiency relative to
the single-device rate, over the process-local devices of the port's
device (ops/meshing.py): the cards of this host, or the one CPU device.
On a card every timing ends in torch.cuda.synchronize().
"""

from __future__ import annotations

import time

from .mesh import batch_from_numpy, build_sharded_step, example_batch, \
    make_mesh


def _devices():
    """The process-local devices of the port's device."""
    from ..device import device as port_device
    from ..ops.meshing import _local_devices
    return _local_devices(port_device())


def _sync(devs):
    """Wait for every device of a mesh (a no-op on the CPU)."""
    import torch
    for dev in {d for row in devs for d in row}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def measure_scaling(device_counts=None, B_per_dev=8, V=32, reps=5):
    """Returns [(n_devices, waves_per_s, bundles_per_s, efficiency)]."""
    ndev = len(_devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]
    results = []
    base_rate = None
    for d in device_counts:
        mesh = make_mesh(d)
        s = mesh.shape["sample"]
        fn = build_sharded_step(mesh)
        B = B_per_dev * mesh.shape["data"]
        args = batch_from_numpy(*example_batch(B=B, V=V, Ns=max(2, s)),
                                mesh.devices[0][0])
        fn(*args)
        _sync(mesh.devices)
        t0 = time.time()
        for _ in range(reps):
            fn(*args)
        _sync(mesh.devices)
        dt = (time.time() - t0) / reps
        waves = 1.0 / dt
        bundles = B / dt
        if base_rate is None:
            base_rate = bundles
        eff = bundles / (base_rate * d) if base_rate else 0.0
        results.append((d, waves, bundles, eff))
    return results


def measure_scaling_shape(device_counts=None, B_per_dev=64, V=32, reps=5):
    """Weak-scaling SHAPE analysis: for each mesh size d, time the sharded
    step at total batch d*B_per_dev on d devices AND the same total batch
    on 1 device, in three interleaved rounds (the median ratio is
    reported with every round's).  Where the d "devices" share one card or
    one host, mesh_vs_single ~ 1.0 shows the sharded program neither gains
    nor loses against one device doing the identical work; per-device bytes
    and dispatch counts are the shape d separate cards would divide."""
    ndev = len(_devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= ndev]
    rows = []
    for d in device_counts:
        B = B_per_dev * d
        mesh_d = make_mesh(d)
        fn_d = build_sharded_step(mesh_d)
        host = example_batch(B=B, V=V, Ns=max(2, mesh_d.shape["sample"]))
        bytes_in = sum(int(a.nbytes) for a in host)
        args = batch_from_numpy(*host, mesh_d.devices[0][0])

        mesh_1 = make_mesh(1)
        fn_1 = build_sharded_step(mesh_1)
        args_1 = batch_from_numpy(*example_batch(
            B=B, V=V, Ns=max(2, mesh_1.shape["sample"])),
            mesh_1.devices[0][0])

        def timed(fn, a, devs):
            out = fn(*a)
            _sync(devs)
            t0 = time.time()
            for _ in range(reps):
                out = fn(*a)
            _sync(devs)
            bytes_out = sum(int(o.nbytes) for o in out)
            return (time.time() - t0) / reps, bytes_out

        rounds = 3
        t_mesh_l, t_one_l, ratios = [], [], []
        bytes_out = 0
        for _ in range(rounds):
            tm, bytes_out = timed(fn_d, args, mesh_d.devices)
            to, _ = timed(fn_1, args_1, mesh_1.devices)
            t_mesh_l.append(tm)
            t_one_l.append(to)
            ratios.append(tm / to if to > 0 else 0.0)
        t_mesh = sorted(t_mesh_l)[rounds // 2]
        t_one = sorted(t_one_l)[rounds // 2]
        ratio_med = sorted(ratios)[rounds // 2]
        rows.append({
            "devices": d,
            "total_batch": B,
            "t_mesh_s": round(t_mesh, 5),
            "t_single_dev_same_work_s": round(t_one, 5),
            "mesh_vs_single": round(ratio_med, 3),
            "mesh_vs_single_rounds": [round(r, 3) for r in ratios],
            "dispatches_per_device": 1,
            "bytes_in_per_device": bytes_in // d,
            "bytes_out_per_device": bytes_out // d,
        })
    last = rows[-1]["mesh_vs_single"] if rows else 0.0
    last_rounds = rows[-1]["mesh_vs_single_rounds"] if rows else []
    unstable = bool(last_rounds) and min(last_rounds) > 0 and \
        max(last_rounds) / min(last_rounds) > 1.4
    contention = bool(rows) and 0.7 <= last <= 1.15 and not unstable
    return {
        "rows": rows,
        "pure_host_contention": contention,
        "window_unstable": unstable,
        "largest_mesh_vs_single": last,
        "note": ("mesh_vs_single ~ 1 at the largest mesh: the sharded "
                 "program neither gains nor loses against one device "
                 "doing the identical work; per-device bytes shrink 1/d"
                 if contention else
                 ("per-round ratios at the largest mesh spread >1.4x: "
                  "this window is too noisy to classify" if unstable else
                  "mesh_vs_single deviates from 1 at the largest mesh: "
                  "sharding itself adds cost at these sizes")),
    }


def format_scaling(results):
    lines = ["scaling (weak, bundles/s):"]
    for d, waves, bundles, eff in results:
        lines.append("  %2d dev: %8.1f bundles/s  eff %.2f" % (d, bundles, eff))
    return "\n".join(lines)


def main():
    """CLI entry for subprocess scaling runs over the port's device
    (ALETSCH_TORCH_DEVICE).  With --shape, also emits the weak-scaling
    shape analysis as one JSON line."""
    import sys
    print(format_scaling(measure_scaling()))
    if "--shape" in sys.argv:
        import json
        print("SHAPE " + json.dumps(measure_scaling_shape()))


if __name__ == "__main__":
    main()
