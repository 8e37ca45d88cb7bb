"""ladder.host_s (s a pass; layer: ladder solver): the native host DPs of
the ladder-paused graphs the export refused to the card (the clock
wave.host_dp.ladder, meta/device_wave.py, one of the four stage parts of
wave.host_dp), the mean over the window's passes: the ladder work the card
did not carry.  None on a program without the stage clocks."""

from bmk.spans import span_s

read = span_s("wave.host_dp.ladder")
