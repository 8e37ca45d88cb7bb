"""region.scan_wait_s (s a pass; layer: incubator): the main thread blocked
on a sample scan of the thread pool (the span region.scan_wait inside
region.start, meta/incubator.py), the mean over the window's passes."""

from bmk.spans import span_s

read = span_s("region.scan_wait")
