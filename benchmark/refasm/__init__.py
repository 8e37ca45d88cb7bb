"""The benchmark's plain reference: a frozen copy of the port's host
assembly path (aletsch_tpu_torch's config, constants, utils, io, core,
bridge, scallop and meta modules, and the C++ host core of native/ at the
repository root, under native/ here), with the card taken out.

It imports nothing of the port, of the JAX package or of jax, and it
builds its own copy of the C++ core into build/benchmark_refasm/ of the
checkout.  The wave orchestrator is a stand-in that never engages a
device (meta/device_wave.py) and the similarity product runs in numpy
(ops/similarity.py), so every region is assembled on the host, as the
port's host mode assembles it.  The port's card modes write the same
bytes as its host mode; the benchmark holds every timed pass's outputs to
what this package writes from the same BAMs (run_reference.py).
"""
