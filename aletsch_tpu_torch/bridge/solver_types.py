"""Bridge result record (bridge/bridge_path.{h,cc})."""

from __future__ import annotations


class BridgePath:
    __slots__ = ("type", "score", "count", "strand", "choices", "stack", "v",
                 "chain", "whole")

    def __init__(self):
        self.type = 0
        self.score = 0
        self.count = 0
        self.strand = 0
        self.choices = 0
        self.stack = []
        self.v = []
        self.chain = []
        self.whole = []
