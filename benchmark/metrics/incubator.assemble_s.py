"""incubator.assemble_s (s a pass; layer: incubator): the Incubator's
assemble-regions phase (meta/incubator.py, Tracer.phase_times, host
clock), the mean over the window's passes."""

from bmk.readers import phase_s

read = phase_s("assemble-regions")
