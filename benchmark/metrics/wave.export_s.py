"""wave.export_s (s a pass; layer: region assembly and device waves): the
native exports of paused graphs and instances into the solvers' staging
rows (the clock wave.export, meta/device_wave.py), the mean over the
window's passes."""

from bmk.spans import span_s

read = span_s("wave.export")
