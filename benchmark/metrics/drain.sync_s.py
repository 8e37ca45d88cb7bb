"""drain.sync_s (s a pass; layer: drain solver): the host blocked on the
card in the drain solver's copies out (fused_sync_time, ops/greedy_fused.py),
from the per-pass change of device_wave.device_stats(); the mean over
the passes where it dispatched."""

from bmk.spans import sync_s

read = sync_s("drain")
