"""Region -> partial exon inference from coverage.

Re-implements rnacore/region.{h,cc} (constructor pipeline region.cc:22-29):
each inter-splice-position segment builds its covered runs from the bundle
coverage map, smooths small gaps when flanked by splice boundaries, drops
empty subregions, and emits partial exons with coverage statistics.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import (END_BOUNDARY, LEFT_SPLICE, RIGHT_SPLICE,
                         START_BOUNDARY)


@dataclass
class PartialExon:
    """rnacore/partial_exon.h:21-40"""
    lpos: int
    rpos: int
    ltype: int
    rtype: int
    ave: float = 0.0
    dev: float = 1.0
    max: float = 0.0
    pvalue: float = 1.0


@dataclass
class Junction:
    """rnacore/junction.h:19-41"""
    lpos: int
    rpos: int
    count: int = 0
    strand: str = "."
    xs0: int = 0
    xs1: int = 0
    xs2: int = 0
    nm: int = 0
    lexon: int = -1
    rexon: int = -1


def build_region_pexons(lpos, rpos, ltype, rtype, mmap, cfg):
    """All partial exons of region [lpos, rpos) (region.cc:34-169)."""
    runs = mmap.covered_runs(lpos, rpos)

    # smooth gaps < min_subregion_gap inside splice-flanked regions
    # (region.cc:60-86): fill gaps from lpos and between runs, then re-join
    if ltype == RIGHT_SPLICE and rtype == LEFT_SPLICE:
        filled = []
        p = lpos
        for (p1, p2) in runs:
            if p1 - p <= cfg.min_subregion_gap:
                filled.append((p, p1))
            p = p2
        if p < rpos and rpos - p <= cfg.min_subregion_gap:
            filled.append((p, rpos))
        if filled:
            merged = sorted(runs + filled)
            runs = []
            for (a, b) in merged:
                if runs and runs[-1][1] >= a:
                    runs[-1] = (runs[-1][0], max(runs[-1][1], b))
                else:
                    runs.append((a, b))

    pexons = []
    assert lpos < rpos

    if len(runs) == 0 and rpos == lpos + 1 and \
            (ltype == END_BOUNDARY or rtype == START_BOUNDARY):
        pe = PartialExon(lpos, rpos, ltype, rtype,
                         ave=cfg.min_guaranteed_edge_weight, dev=1.0)
        return [pe]

    if len(runs) >= 1 and runs[0][0] == lpos and runs[0][1] == rpos:
        pe = PartialExon(lpos, rpos, ltype, rtype)
        pe.ave, pe.dev, pe.max = mmap.evaluate_rectangle(lpos, rpos)
        return [pe]

    if ltype == RIGHT_SPLICE and not any(a <= lpos < b for a, b in runs):
        pe = PartialExon(lpos, lpos + 1, ltype, END_BOUNDARY,
                         ave=cfg.min_guaranteed_edge_weight, dev=1.0)
        pexons.append(pe)

    for (p1, p2) in runs:
        b = _empty_subregion(mmap, p1, p2, cfg)
        if p1 == lpos and ltype == RIGHT_SPLICE:
            b = False
        if p2 == rpos and rtype == LEFT_SPLICE:
            b = False
        if b:
            continue
        lt = ltype if p1 == lpos else START_BOUNDARY
        rt = rtype if p2 == rpos else END_BOUNDARY
        pe = PartialExon(p1, p2, lt, rt)
        pe.ave, pe.dev, pe.max = mmap.evaluate_rectangle(p1, p2)
        pexons.append(pe)

    if rtype == LEFT_SPLICE and not any(a < rpos <= b for a, b in runs):
        pe = PartialExon(rpos - 1, rpos, START_BOUNDARY, rtype,
                         ave=cfg.min_guaranteed_edge_weight, dev=1.0)
        pexons.append(pe)

    return pexons


def _empty_subregion(mmap, p1, p2, cfg):
    """region.cc:88-107"""
    if p2 - p1 < cfg.min_subregion_length:
        return True
    s = mmap.sum_overlap(p1, p2)
    if s <= 0:
        return True
    ratio = s / (p2 - p1)
    return ratio < cfg.min_subregion_overlap
