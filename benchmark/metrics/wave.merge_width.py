"""wave.merge_width (waves a call; layer: region assembly and device
waves): the mean number of region waves that the replay thread ran as one
call of device_wave.assemble_groups, over the calls that merged two or
more (the counters merged_waves / merge_calls of the device stats,
meta/device_wave.py ReplayQueue.get), a pass, the mean over the window's
passes.  None where no call merged, and on a program that does not merge
waves."""

from bmk.readers import per_pass


def pass_merge_width(p):
    calls = p.stats.get("merge_calls")
    if not calls:
        return None
    return p.stats["merged_waves"] / calls


def read(run):
    return per_pass(run, pass_merge_width)
