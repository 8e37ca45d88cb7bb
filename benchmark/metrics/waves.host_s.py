"""waves.host_s (s a pass; layer: region assembly and device waves):
assemble-regions less the sum of the solvers' solve() clocks over the
pass, the host's share of region assembly: graph building and
decomposition, and the device waves' group assembly, packing and host
refusals (meta/incubator.py over meta/device_wave.py)."""

from bmk.readers import host_s, per_pass


def read(run):
    return per_pass(run, host_s)
