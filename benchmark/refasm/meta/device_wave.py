"""Stand-in for the port's wave orchestrator (aletsch_tpu_torch/meta/
device_wave.py): the reference assembles every group on the host, so no
wave engages a device and no stage asks a policy."""

stats = {}


def enabled(cfg, n_groups):
    """No wave runs through a device path."""
    return False


def auto_device_ok(cfg, n_graphs=64, stage="drain"):
    """No stage engages a device."""
    return False


def assemble_groups(asms, gvs, cfg):
    raise RuntimeError("the reference assembles every group on the host")


def device_stats():
    return {}
