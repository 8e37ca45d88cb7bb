"""drain_kernel_roofline (%; layer: kernels): csrc/drain.cu's share of
its roofline over the traced window: the least time of its launches'
live rows (bmk/roofline.py::drain_launch, from each dispatch's staged
sinks and path counts) over its records' device time in the trace."""

from bmk import roofline

LOG = "drain_launches"


def install(hooks):
    from aletsch_tpu_torch.ops.greedy_fused import DeviceGreedyFused

    def before(solver, nrows):
        return solver.sink[:nrows].copy()

    def after(args, sink, out):
        solver, nrows = args[0], args[1]
        if nrows == 0:
            return None
        paths, ws, npaths = out
        return roofline.drain_launch(sink, npaths, paths.shape[2],
                                     paths.shape[1], ws.dtype.itemsize)

    hooks.wrap(DeviceGreedyFused, "solve", before=before, after=after,
               log=LOG)


def read(run):
    launches = [x for x in run.logs.get(LOG, []) if x is not None]
    return roofline.share(launches, run.trace, "drain_kernel")
