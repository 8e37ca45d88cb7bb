"""replay.fold_s (s a pass; layer: region assembly and device waves): the
replay thread folding each region's transcript sets into the global
ones, releasing its groups, and saving its checkpoint where there is one
(the span replay.fold, meta/incubator.py; its clock starts where the
region's wave, or for a region without one replay.idle, ended), the mean
over the window's passes."""

from bmk.spans import span_s

read = span_s("replay.fold")
