"""Transcript-level filters (rnacore/filter.{h,cc})."""

from __future__ import annotations


def verify_length_coverage(t, cfg):
    """filter.cc:303-321"""
    e = len(t.exons)
    minl = cfg.min_transcript_length_base + e * cfg.min_transcript_length_increase
    if e == 1 and t.length() < cfg.min_single_exon_transcript_length:
        return False
    if e >= 2 and t.length() < minl:
        return False
    if e == 1 and t.coverage < cfg.min_single_exon_transcript_coverage * cfg.assembly_repeats:
        return False
    if e >= 2 and t.coverage < cfg.min_transcript_coverage * cfg.assembly_repeats:
        return False
    return True


def verify_exon_length(t, cfg):
    """filter.cc:293-301"""
    for a, b in t.exons:
        if b - a < cfg.min_exon_length:
            return False
    return True


def remove_nested_transcripts(trs):
    """filter.cc:27-67"""
    removed = set()
    for i, ti in enumerate(trs):
        v = ti.exons
        if len(v) <= 1:
            continue
        w1 = ti.coverage
        b = False
        for k in range(1, len(v)):
            p = v[k - 1][1]
            q = v[k][0]
            for tj in trs:
                if len(tj.exons) <= 1:
                    continue
                pq = tj.get_bounds()
                if tj.coverage >= w1 and pq[0] > p and pq[1] < q:
                    b = True
                    break
            if b:
                break
        if b:
            removed.add(i)
    return [t for i, t in enumerate(trs) if i not in removed]


def join_single_exon_transcripts(trs, cfg):
    """filter.cc:69-143"""
    trs = list(trs)
    while True:
        if not _join_transcripts(trs, cfg):
            break
    return trs


def _join_transcripts(trs, cfg):
    trs.sort(key=lambda t: t.exons[0][0] if t.exons else 0)
    mind = cfg.min_bundle_gap
    ki = kj = -1
    for i in range(len(trs)):
        j = _locate_next_transcript(trs, i)
        if j == -1:
            continue
        if len(trs[i].exons) >= 2 and len(trs[j].exons) >= 2:
            continue
        d = trs[j].get_bounds()[0] - trs[i].get_bounds()[1]
        if d > mind:
            continue
        mind = d
        ki, kj = i, j
    if ki == -1 or kj == -1:
        return False
    if mind > cfg.min_bundle_gap - 1:
        return False
    if len(trs[ki].exons) >= 2:
        p1 = trs[ki].get_bounds()[1]
        p2 = trs[kj].get_bounds()[1]
        trs[ki].add_exon(p1, p2)
        trs[ki].sort()
        trs[ki].shrink()
        del trs[kj]
        return True
    elif len(trs[kj].exons) >= 2:
        p1 = trs[ki].get_bounds()[0]
        p2 = trs[kj].get_bounds()[0]
        trs[kj].add_exon(p1, p2)
        trs[kj].sort()
        trs[kj].shrink()
        del trs[ki]
        return True
    else:
        p1 = trs[ki].get_bounds()[0]
        p2 = trs[kj].get_bounds()[0]
        trs[kj].add_exon(p1, p2)
        trs[kj].sort()
        trs[kj].shrink()
        cov = (trs[ki].coverage * trs[ki].length()
               + trs[kj].coverage * trs[kj].length())
        cov /= (trs[ki].length() + trs[kj].length())
        trs[kj].coverage = cov
        del trs[ki]
        return True


def _locate_next_transcript(trs, t):
    """filter.cc:145-163"""
    if t < 0 or t >= len(trs):
        return -1
    p = trs[t].get_bounds()
    a, b = 0, len(trs) - 1
    if trs[b].get_bounds()[0] < p[1]:
        return -1
    while True:
        if a == b:
            return a
        k = (a + b) // 2
        f = trs[k].get_bounds()[0]
        if f == p[1]:
            return k
        if f < p[1]:
            a = k + 1
        else:
            b = k


def merge_single_exon_transcripts(trs):
    """Drop unstranded single-exon transcripts covered by another exon
    (filter.cc:165-274)."""
    by_chr = {}
    for t in trs:
        by_chr.setdefault(t.seqname, []).append(t)
    out = []
    for _, group in sorted(by_chr.items()):
        out.extend(_merge_single_exon_chr(group))
    return out


def _merge_single_exon_chr(trs0):
    vv = []
    for i, t in enumerate(trs0):
        for ex in t.exons:
            vv.append((ex, i))
    vv.sort()
    fb = set()
    for i, (ex1, k1) in enumerate(vv):
        p1, q1 = ex1
        t1 = trs0[k1]
        if len(t1.exons) != 1 or t1.strand != ".":
            continue
        b = False
        for k in range(i - 1, max(-1, i - 11), -1):
            (p2, q2), k2 = vv[k]
            if k2 in fb:
                continue
            t2 = trs0[k2]
            if t2.seqname != t1.seqname:
                continue
            if q2 < q1:
                continue
            b = True
            break
        if not b:
            for k in range(i + 1, len(vv)):
                (p2, q2), k2 = vv[k]
                if k2 in fb:
                    continue
                t2 = trs0[k2]
                if t2.seqname != t1.seqname:
                    continue
                if p2 > p1:
                    break
                if q2 < q1:
                    continue
                b = True
                break
        if b:
            fb.add(k1)
    return [t for i, t in enumerate(trs0) if i not in fb]
