"""bridge_kernel_roofline (%; layer: kernels): csrc/bridge.cu's share of
its roofline over the traced window: the least time of its launches'
live rows (bmk/roofline.py::bridge_launch, from each dispatch's staged
in-edge lists and targets and the entries it wrote) over its records'
device time in the trace."""

from bmk import roofline

LOG = "bridge_launches"


def install(hooks):
    from aletsch_tpu_torch.ops.bridge_topk import DeviceBridge

    def before(solver, nrows):
        return solver.P[:nrows].copy(), solver.tgt[:nrows].copy()

    def after(args, staged, out):
        if args[1] == 0:
            return None
        ostk, par, pix = out
        return roofline.bridge_launch(staged[0], staged[1], pix,
                                      ostk.shape[-1])

    hooks.wrap(DeviceBridge, "solve", before=before, after=after, log=LOG)


def read(run):
    launches = [x for x in run.logs.get(LOG, []) if x is not None]
    return roofline.share(launches, run.trace, "bridge_kernel")
