"""Entry point of the batched wave step on one device.

Counterpart of __graft_entry__.py::entry at the repository root, which
belongs to the JAX package.  The multi-card dry run of that file is not
ported yet.
"""

from .device import device as port_device
from .parallel.mesh import batch_from_numpy, example_batch, step


def entry(device=None):
    """The batched assembly step and example arguments on the port's
    device (or the one given): step(*args) runs one wave."""
    dev = port_device() if device is None else device
    return step, batch_from_numpy(*example_batch(B=8, V=32), dev)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
