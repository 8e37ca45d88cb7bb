"""device.idle_share (%; layer: device): 1 - the union of the device
records' intervals over the one capture of the traced window, in %."""


def read(run):
    if run.trace is None:
        return None
    share = run.trace.idle_share()
    return None if share is None else 100.0 * share
