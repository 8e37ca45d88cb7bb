"""Sorted coordinate-sequence relations.

Re-implementation of the 10-way classifier and merge/overlap helpers the
reference uses for intron chains and phasing paths
(util/util.h:190-335).  Chains are plain Python tuples/lists
of ints (already sorted strictly increasing in valid inputs).
"""

from bisect import bisect_left

from ..constants import (CONFLICTING, CONTAINED, CONTAINING, EXTEND_LEFT,
                         EXTEND_RIGHT, FALL_LEFT, FALL_RIGHT, IDENTICAL,
                         NESTED, NESTING)


def check_increasing(x) -> bool:
    return all(x[k] <= x[k + 1] for k in range(len(x) - 1))


def compare_sorted(ref, qry) -> int:
    """Classify the relation of two sorted sequences (util.h:191-248).

    Returns one of the position constants; ref is the first argument of the
    reference's compare_two_sorted_sequences.
    """
    assert len(ref) >= 1 and len(qry) >= 1
    if ref[-1] < qry[0]:
        return FALL_RIGHT
    if ref[0] > qry[-1]:
        return FALL_LEFT

    kr1 = bisect_left(ref, qry[0])
    kq1 = bisect_left(qry, ref[0])
    assert kr1 < len(ref) and kq1 < len(qry)

    kq2 = bisect_left(qry, ref[-1])
    kr2 = bisect_left(ref, qry[-1])
    r2_end = kr2 >= len(ref)
    q2_end = kq2 >= len(qry)

    def identical(x1, x2, y1, y2):
        if x2 - x1 != y2 - y1:
            return False
        return ref[x1:x2 + 1] == qry[y1:y2 + 1] or \
            list(ref[x1:x2 + 1]) == list(qry[y1:y2 + 1])

    if qry[kq1] == ref[0] or ref[kr1] == qry[0]:
        if not r2_end and not q2_end:
            if ref[-1] != qry[-1]:
                return CONFLICTING
            b = identical(kr1, len(ref) - 1, kq1, len(qry) - 1)
            if not b:
                return CONFLICTING
            if kr1 == 0 and kq1 == 0:
                return IDENTICAL
            if kr1 >= 1 and kq1 == 0:
                return CONTAINED
            if kr1 == 0 and kq1 >= 1:
                return CONTAINING
            raise AssertionError
        elif not r2_end and q2_end:
            b = identical(kr1, kr2, kq1, len(qry) - 1)
            if not b:
                return CONFLICTING
            return CONTAINED if kq1 == 0 else EXTEND_LEFT
        elif r2_end and not q2_end:
            b = identical(kr1, len(ref) - 1, kq1, kq2)
            if not b:
                return CONFLICTING
            return CONTAINING if kr1 == 0 else EXTEND_RIGHT
        return CONFLICTING
    elif ref[kr1] > qry[0] and kr2 == kr1 and not r2_end and ref[kr2] > qry[-1]:
        return NESTED
    elif qry[kq1] > ref[0] and kq2 == kq1 and not q2_end and qry[kq2] > ref[-1]:
        return NESTING
    return CONFLICTING


def merge_sorted(ref, qry):
    """Merge two compatible sorted sequences (util.h:251-299).

    Returns (ok, merged).
    """
    if len(ref) == 0:
        return True, list(qry)
    if len(qry) == 0:
        return True, list(ref)

    t = compare_sorted(ref, qry)
    if t in (CONFLICTING, NESTED, NESTING):
        return False, []
    if t in (IDENTICAL, CONTAINED):
        return True, list(ref)
    if t == CONTAINING:
        return True, list(qry)
    if t == FALL_RIGHT:
        return True, list(ref) + list(qry)
    if t == FALL_LEFT:
        return True, list(qry) + list(ref)
    if t == EXTEND_LEFT:
        q1 = bisect_left(qry, ref[0])
        assert qry[q1] == ref[0]
        return True, list(qry[:q1]) + list(ref)
    if t == EXTEND_RIGHT:
        q2 = bisect_left(qry, ref[-1])
        assert qry[q2] == ref[-1]
        return True, list(ref) + list(qry[q2 + 1:])
    raise AssertionError


def overlap_sorted(ref, qry):
    """Overlap of two compatible sorted sequences (util.h:302-335)."""
    if len(ref) == 0 or len(qry) == 0:
        return True, []
    t = compare_sorted(ref, qry)
    if t in (CONFLICTING, NESTED, NESTING, FALL_RIGHT, FALL_LEFT):
        return False, []
    if t in (IDENTICAL, CONTAINING):
        return True, list(ref)
    if t == CONTAINED:
        return True, list(qry)
    if t == EXTEND_LEFT:
        q1 = bisect_left(qry, ref[0])
        return True, list(qry[q1:])
    if t == EXTEND_RIGHT:
        q2 = bisect_left(qry, ref[-1])
        return True, list(qry[:q2 + 1])
    raise AssertionError


def merge_intron_chains(x, y):
    """Merge two intron chains (rnacore/essential.cc:474-483).

    Returns (ok, merged); requires x.front() <= y.front() and an even overlap
    difference so that intron pairing is preserved.
    """
    if len(x) >= 1 and len(y) >= 1 and x[0] > y[0]:
        return False, []
    ok, xy = merge_sorted(x, y)
    if not ok:
        return False, []
    d = len(x) + len(y) - len(xy)
    if d % 2 != 0:
        return False, []
    return True, xy


def consistent_intron_chains(x, y) -> bool:
    return merge_intron_chains(x, y)[0]


def consecutive_subset(ref, x):
    """All start offsets where x appears consecutively in ref (util.h:142-162)."""
    v = []
    if len(x) == 0 or len(ref) == 0 or len(x) > len(ref):
        return v
    for i in range(len(ref) - len(x) + 1):
        if ref[i] != x[0]:
            continue
        if all(ref[i + j] == x[j] for j in range(len(x))):
            v.append(i)
    return v


def string_hash(s: str) -> int:
    """Deterministic 64-bit FNV-1a string hash (stand-in for util string_hash)."""
    h = 0xcbf29ce484222325
    for c in s.encode():
        h ^= c
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h


def vector_hash(v) -> int:
    """Deterministic 64-bit hash of an int sequence (stand-in for vector_hash)."""
    h = 0xcbf29ce484222325
    for x in v:
        h ^= (x & 0xFFFFFFFFFFFFFFFF)
        h = (h * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h
