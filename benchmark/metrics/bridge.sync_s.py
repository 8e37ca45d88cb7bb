"""bridge.sync_s (s a pass; layer: bridge solver): the host blocked in the
bridge solver's sync (bridge_sync_time, ops/bridge_topk.py), from the
per-pass change of device_wave.device_stats(); the mean over the passes
where it dispatched."""

from bmk.spans import sync_s

read = sync_s("bridge")
