"""wave.host_dp_s (s a pass; layer: region assembly and device waves): the
native host DPs of the instances the exports refused (the clock
wave.host_dp, meta/device_wave.py), the mean over the window's passes."""

from bmk.spans import span_s

read = span_s("wave.host_dp")
