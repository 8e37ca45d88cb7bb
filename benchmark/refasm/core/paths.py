"""Decomposed path record (rnacore/path.{h,cc})."""

from __future__ import annotations


class Path:
    __slots__ = ("v", "junc", "weight", "abd", "conf", "reads", "count",
                 "strand", "length")

    def __init__(self):
        self.v = []          # vertex list incl. source/sink
        self.junc = []       # junction vertex pairs [(v1, v2), ...]
        self.weight = 0.0
        self.abd = 0.0
        self.conf = 0.0
        self.reads = 0.0
        self.count = 0
        self.strand = "."
        self.length = 0
