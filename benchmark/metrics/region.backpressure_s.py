"""region.backpressure_s (s a pass; layer: incubator): the main thread
blocked handing a region to the full replay queue, so that the device
waves set the pace (the span region.backpressure, meta/incubator.py),
the mean over the window's passes."""

from bmk.spans import span_s

read = span_s("region.backpressure")
