"""wave.pool_task_s (seconds a pass; layer: region assembly and device
waves): the seconds the native wave pool's tasks took, summed over every
thread that ran one (the clock pool_task_s of the device stats,
meta/device_wave.py over csrc/wave_pool.cpp: each wave's starts and each
flush's resumes after a solve(), on a pool thread or on the calling
thread), a pass, the mean over the window's passes.  The native work of
the waves that wave.native_s, the replay thread's time blocked in native
calls, does not see where pool threads do it.  None on a program without
the pool."""

from bmk.readers import per_pass


def read(run):
    return per_pass(run, lambda p: p.stats.get("pool_task_s"))
