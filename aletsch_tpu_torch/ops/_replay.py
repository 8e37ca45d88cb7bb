"""The batch sizes the wave solvers ship.

The ladder solver (ops/ladder_device.py) ships its live rows and, behind
them, staged rows up to the next power of two, switched off.
"""

from __future__ import annotations


def bucket(n, cap):
    """The smallest power of two >= n, at most cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)
