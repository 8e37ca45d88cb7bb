"""Pairwise splice-set similarity: set intersections as a binary matmul.

Counterpart of aletsch_tpu/ops/similarity.py.  The reference computes
O(n^2) sorted set intersections per region (meta/bundle_group.cc:190-231);
here a per-region bundle x splice incidence matrix (splices
coordinate-compressed) gives the intersection-count matrix C = A @ A^T,
then r = C / min(|A|, |B|).

Only the host form is here: the JAX package's device forms (the dense
matmul and the sparse COO form with its on-device threshold, engaged from
48 bundles up) return the same pair lists as the host form by
construction, so the lists of this module equal the JAX package's at every
size.  The device forms are not ported yet (ROADMAP Queue 1 item 8), and a
forced --device_similarity on is refused by meta/device_wave.py.
"""

from __future__ import annotations

import numpy as np


def _intersection_matrix_host(inc):
    return inc @ inc.T


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
    c = _intersection_matrix_host(inc)
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
