"""bridge.solve_s (s a pass; layer: bridge solver): the bridge solver's solve()
host clock (copies, launch, sync) over a pass, from the per-pass change
of device_wave.device_stats(); the mean over the passes where it
dispatched."""

from bmk.readers import solve_s

read = solve_s("bridge")
