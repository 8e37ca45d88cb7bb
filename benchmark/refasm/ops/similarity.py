"""Pairwise splice-set similarity: set intersections as a binary matmul.

Frozen copy of aletsch_tpu_torch/ops/similarity.py's host form.  The
reference computes O(n^2) sorted set intersections per region
(meta/bundle_group.cc:190-231); here a per-region bundle x splice
incidence matrix (splices coordinate-compressed) gives the
intersection-count matrix C = A @ A^T, then r = C / min(|A|, |B|).  The
port's device forms return this form's pair list bit for bit; the
reference keeps the host form alone.
"""

from __future__ import annotations

import numpy as np


def pairwise_splice_similarity(splice_lists, min_similarity):
    """Return [(i, j, count, ratio)] for i < j with count > 0.5 and
    ratio >= min_similarity; ratio = |A ^ B| / min(|A|, |B|)."""
    n = len(splice_lists)
    if n <= 1:
        return []
    sizes = np.array([len(s) for s in splice_lists], dtype=np.int64)
    # coordinate-compress splice positions
    allp = sorted({p for s in splice_lists for p in s})
    if len(allp) == 0:
        return []
    pidx = {p: i for i, p in enumerate(allp)}
    inc = np.zeros((n, len(allp)), dtype=np.float32)
    for i, s in enumerate(splice_lists):
        for p in s:
            inc[i, pidx[p]] = 1.0
    c = inc @ inc.T
    out = []
    mins = np.minimum(sizes[:, None], sizes[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(mins > 0, c / mins, 0.0)
    ii, jj = np.nonzero((c > 0.50) & (r >= min_similarity))
    for i, j in zip(ii.tolist(), jj.tolist()):
        if i >= j:
            continue
        out.append((i, j, float(c[i, j]), float(r[i, j])))
    return out
