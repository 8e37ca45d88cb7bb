"""wave.native_s (s a pass; layer: region assembly and device waves): the
native group runs inside the device waves: their starts, the consumes
after each solve() that resume them to their next pause, and their
finishes (the spans wave.start, wave.consume.<stage> and wave.finish,
meta/device_wave.py), the mean over the window's passes."""

from bmk.spans import native_s

read = native_s
