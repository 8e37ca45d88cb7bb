"""ladder_kernel_roofline (%; layer: kernels): csrc/ladder.cu's share of
its roofline over the traced window: the least time of its launches'
live rows (bmk/roofline.py::ladder_launch, from each dispatch's staged
edge, vertex and hyper-edge counts and the event counts the kernel
wrote) over its records' device time in the trace.  The event counts are
read from the solver's host copy of the kernel's outputs, checked
against the decision counts solve() returns; a dispatch whose counts
cannot be read (no card, another layout) makes the metric silent."""

import numpy as np

from bmk import roofline

LOG = "ladder_launches"
BAD = "unread"


def install(hooks):
    from aletsch_tpu_torch.ops.ladder_device import DeviceLadder

    def after(args, _, out):
        solver, nrows = args[0], args[1]
        if nrows == 0:
            return None
        larm, ltgt, ndec, status = out
        if solver.device.type != "cuda":
            return BAD
        try:
            D = larm.shape[1]
            rows = roofline.bucket(nrows, solver.batch)
            host = solver._out.numpy()[:rows * (2 * D + 3)]
            tail = host[2 * rows * D:].reshape(3, rows)
            meta = solver.meta3[:nrows]
            hedge = solver.hedge[:nrows].reshape(nrows, -1)
            hlen = solver.hlen[:nrows]
        except (AttributeError, ValueError):
            return BAD
        if not np.array_equal(tail[0][:nrows], ndec):
            return BAD
        return roofline.ladder_launch(
            meta[:, 0], meta[:, 2], (hedge >= 0).sum(axis=1),
            (hlen > 0).sum(axis=1), rows, ndec, tail[2][:nrows])

    hooks.wrap(DeviceLadder, "solve", after=after, log=LOG)


def read(run):
    logged = run.logs.get(LOG, [])
    if BAD in logged:
        return None
    return roofline.share([x for x in logged if x is not None], run.trace,
                          "ladder_kernel")
