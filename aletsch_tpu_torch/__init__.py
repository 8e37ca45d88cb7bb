"""aletsch_tpu_torch: the PyTorch/CUDA port of aletsch_tpu for NVIDIA Hopper.

A package of its own: it imports torch, never jax and nothing of
aletsch_tpu.  Each host module it runs (config, constants, utils, io, core,
bridge, scallop, meta) is its own copy of the JAX package's module of the
same sub-package and name, and tests/test_torch_host_copies.py holds the
copies to their originals.  It owns the device side: the wave orchestrator
(meta/device_wave.py) and the kernels, written by hand in CUDA C++ (csrc/)
with a plain PyTorch version beside each (ops/).  The C++ host core
(native/ at the repository root) is loaded through io/bam_native.py and
meta/native_core.py.  The device comes from ALETSCH_TORCH_DEVICE
(device.py), default "cuda".
"""

from .device import device

__all__ = ["device"]
