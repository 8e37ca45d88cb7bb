"""ladder.sync_s (s a pass; layer: ladder solver): the host blocked in the
ladder solver's sync (ladder_sync_time, ops/ladder_device.py), from the
per-pass change of device_wave.device_stats(); the mean over the passes
where it dispatched."""

from bmk.spans import sync_s

read = sync_s("ladder")
