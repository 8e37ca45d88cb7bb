"""wave.pool_width (handles a batch; layer: region assembly and device
waves): the mean concurrency of the native wave pool, the paused group
runs in each batch of two or more that it advanced together (the counters
pool_handles / pool_calls of the device stats, meta/device_wave.py: each
region's starts and each flush's resumes after a solve()), a pass, the
mean over the window's passes.  None where the pool took no batch, and on
a program without the pool."""

from bmk.readers import per_pass


def pass_pool_width(p):
    calls = p.stats.get("pool_calls")
    if not calls:
        return None
    return p.stats["pool_handles"] / calls


def read(run):
    return per_pass(run, pass_pool_width)
