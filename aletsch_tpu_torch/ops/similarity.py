"""Pairwise splice-set similarity: set intersections as a binary matmul.

Counterpart of aletsch_tpu/ops/similarity.py.  The reference computes
O(n^2) sorted set intersections per region (meta/bundle_group.cc:190-231);
here a per-region bundle x splice incidence matrix (splices
coordinate-compressed) gives the intersection-count matrix C = A @ A^T,
then r = C / min(|A|, |B|).  Small subsets stay in numpy: below
_DEVICE_THRESHOLD bundles a dispatch costs more than the product.

Two device forms, plain PyTorch on the port's device, both returning the
host form's pair list bit for bit:

- dense: the incidence goes up as [n, P] f32, torch.matmul runs there, the
  [n, n] counts come back and the host thresholds them;
- sparse: the incidence goes up as COO pairs (O(nnz)), one scatter makes
  it dense on the device, the same product runs, the device thresholds
  conservatively (in exact-integer slack) and only a top-K compaction of
  the qualifying pair indices and counts comes back (O(K)); the exact f64
  ratio test reruns on the host over those candidates.  When more than K
  pairs qualify it declines and the dense form takes over.

Exactness of the product: the entries are 0.0 and 1.0 and a count is at
most the number of splice positions, far below 2^24, so every partial sum
is an integer that f32 holds exactly whatever the order of the sum; TF32
inputs hold 0.0 and 1.0 exactly and accumulate in f32, so the product is
exact there too.  _counts pins allow_tf32 off all the same, so that the
result never rests on which of the two the library picks.

stats counts the dispatches of each form, as the solvers count theirs.
torch is imported by the device forms only: meta/bundle_group.py imports
this module in every run, and a run that keeps similarity on the host
never loads torch.
"""

from __future__ import annotations

import numpy as np

from ..device import device as port_device

_DEVICE_THRESHOLD = 48    # below this, host numpy wins
_K_CAP = 131072           # compacted candidate-pair download cap (~1 MB)

stats = {"similarity_dense": 0,      # dense products run on the device
         "similarity_sparse": 0,     # sparse dispatches whose list was used
         "similarity_overflow": 0}   # sparse dispatches that declined


def _intersection_matrix_host(inc):
    return inc @ inc.T


def _counts(inc, against=None):
    """inc @ against.T (against defaults to inc) in f32 with TF32 off (see
    the module docstring)."""
    import torch
    other = inc if against is None else against
    if inc.device.type != "cuda":
        return torch.matmul(inc, other.T)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(inc, other.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _intersection_matrix_device(inc, device=None):
    """The dense form: inc [n, P] f32 numpy up, counts [n, n] f32 numpy
    down, C-contiguous.  No padding: the reference pads to 128-buckets
    for its compile cache, and nothing is compiled here."""
    import torch
    dev = port_device() if device is None else torch.device(device)
    c = _counts(torch.from_numpy(np.ascontiguousarray(
        inc, dtype=np.float32)).to(dev))
    stats["similarity_dense"] += 1
    return c.cpu().numpy()


def _sparse_candidates(rows, cols, sizes, thresh, n_splices, K):
    """The sparse form's device part.  rows, cols: [nnz] int64 COO of the
    incidence; sizes: [n] int32; thresh: 0-dim f32.  Returns (idx [K] i64
    flat row-major pair indices in ascending order, dead tail 0; cv [K] f32
    counts; live [K] bool; nq 0-dim: how many pairs qualified)."""
    import torch
    n = sizes.shape[0]
    dev = sizes.device
    inc = torch.zeros((n, n_splices), dtype=torch.float32, device=dev)
    # accumulate is unordered on CUDA; every addend is 1.0 and no (row,
    # col) repeats, so no order can change a sum
    inc.index_put_((rows, cols), torch.ones((), dtype=torch.float32,
                                            device=dev).expand(rows.shape),
                   accumulate=True)
    c = _counts(inc)
    szf = sizes.to(torch.float32)
    mins = torch.minimum(szf[:, None], szf[None, :])
    ii = torch.arange(n, device=dev)
    upper = ii[:, None] < ii[None, :]
    # conservative integer-slack threshold: c and mins are exact small
    # ints in f32, so any pair the exact f64 host test accepts satisfies
    # c >= thresh*mins - 0.5 here (f32 product error << 0.5); the exact
    # test reruns on host over the compacted candidates
    qual = upper & (c > 0.5) & (c >= thresh * mins - 0.5)
    flat = qual.reshape(-1)
    nq = flat.sum()
    # encode so topk returns candidates in ascending flat (row-major)
    # order — the host path's np.nonzero order, which the stable ratio
    # sort tie-breaks on.  Only the values are used: equal zeros in the
    # dead tail cannot reorder anything
    pos = torch.arange(n * n, device=dev)
    enc = torch.where(flat, n * n - pos, torch.zeros_like(pos))
    topv = torch.topk(enc, K).values
    live = topv > 0
    idx = torch.where(live, n * n - topv, torch.zeros_like(topv))
    cv = c.reshape(-1)[idx]
    return idx, cv, live, nq


def _pairs_device_sparse(splice_lists, sizes, pidx, n_splices,
                         min_similarity, device=None):
    """COO upload + on-device threshold + compact download; returns the
    [(i, j, count, ratio)] list bit-identical to the host path, or None
    to fall back (more than K candidates).  K = min(_K_CAP, n * n): the
    reference's cap over its 128-padded n, which bounds the same download;
    no padding of n, P or nnz is kept, since padded rows exist there only
    to bound the number of compiled shapes."""
    import torch
    dev = port_device() if device is None else torch.device(device)
    n = len(splice_lists)
    rows_l, cols_l = [], []
    for i, s in enumerate(splice_lists):
        for p in s:
            rows_l.append(i)
            cols_l.append(pidx[p])
    K = min(_K_CAP, n * n)
    rows = torch.tensor(rows_l, dtype=torch.int64).to(dev)
    cols = torch.tensor(cols_l, dtype=torch.int64).to(dev)
    szs = torch.from_numpy(np.asarray(sizes, dtype=np.int32)).to(dev)
    thresh = torch.tensor(min_similarity, dtype=torch.float32).to(dev)
    idx, cv, live, nq = _sparse_candidates(rows, cols, szs, thresh,
                                           n_splices, K)
    if int(nq) > K:
        stats["similarity_overflow"] += 1
        return None             # candidate overflow: dense fallback
    idx = idx.cpu().numpy()
    cv = cv.cpu().numpy()
    live = live.cpu().numpy()
    stats["similarity_sparse"] += 1
    out = []
    for k in range(len(idx)):
        if not live[k]:
            break               # descending-encoded: dead tail
        i, j = divmod(int(idx[k]), n)
        c = float(cv[k])
        # exact f64 ratio test, identical to the host expression
        mn = min(sizes[i], sizes[j])
        r = c / mn if mn > 0 else 0.0
        if c > 0.50 and r >= min_similarity:
            out.append((i, j, c, r))
    return out


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
    if n >= _DEVICE_THRESHOLD:
        res = _pairs_device_sparse(splice_lists, sizes, pidx, len(allp),
                                   min_similarity)
        if res is not None:
            return res
    inc = np.zeros((n, len(allp)), dtype=np.float32)
    for i, s in enumerate(splice_lists):
        for p in s:
            inc[i, pidx[p]] = 1.0
    if n >= _DEVICE_THRESHOLD:
        c = _intersection_matrix_device(inc)
    else:
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
