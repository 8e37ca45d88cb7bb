"""wave.python_s (s a pass; layer: region assembly and device waves): the
device waves less their native calls (wave.native_s), exports
(wave.export_s), host DPs (wave.host_dp_s) and every solver's solve()
clock: the Python orchestration's own time, waits for the GIL
included, the mean over the window's passes."""

from bmk.spans import python_s

read = python_s
