"""The benchmark's traffic generator: a frozen copy of the port's cohort
builder (aletsch_tpu_torch/cohorts.py) and of the parts of sim.py,
io/bam.py and io/bgzf.py it uses.  It imports nothing of the port, so a
change to the port cannot change the benchmark's inputs; the benchmark's
tests hold its bytes to the port's at a small cut."""
