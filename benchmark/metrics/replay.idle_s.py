"""replay.idle_s (s a pass; layer: region assembly and device waves): the
replay thread blocked on an empty queue, so that the main thread sets
the pace (the span replay.idle, meta/incubator.py; with wave and
replay.fold it tiles the thread's time, so its clock also holds the
queue's bookkeeping since the last region), the mean over the window's
passes."""

from bmk.spans import span_s

read = span_s("replay.idle")
