"""The port's device, chosen explicitly.

ALETSCH_TORCH_DEVICE names it ("cuda", "cuda:1", "cpu"); the default is
"cuda".  Asking for CUDA on a machine without a usable card raises: nothing
moves to the CPU by itself.  The CPU tests set "cpu", where every kernel
wrapper runs its plain PyTorch version.  torch is imported when the device
is first asked for: the package imports this module, and a run that never
engages the card never loads torch.
"""

from __future__ import annotations

import os

ENV = "ALETSCH_TORCH_DEVICE"


def device():
    import torch
    dev = torch.device(os.environ.get(ENV, "cuda"))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("%s=%s: the port runs on cuda or cpu" % (ENV, dev))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "%s=%s but torch.cuda.is_available() is False; set %s=cpu to "
            "run the plain PyTorch versions" % (ENV, dev, ENV))
    return dev
