"""Random-forest transcript scoring as batched JAX inference.

Replaces the reference's sklearn side-car (score.py:59-94) with a TPU-ready
decision-forest evaluator: each tree is flattened into dense node arrays
(feature, threshold, children, leaf probability) and all (tree, sample)
lookups run as vectorized gathers inside one jit; probabilities average over
trees exactly like RandomForestClassifier.predict_proba.

Models can be converted from a fitted sklearn forest (the published Aletsch
model is a joblib RandomForestClassifier) or trained here via train_forest.

Counterpart of aletsch_tpu/scoring/forest.py: where the JAX package jits
the descent, the port runs it as plain PyTorch on its device
(ALETSCH_TORCH_DEVICE), bit for bit equal to _predict_numpy, and a device
failure propagates instead of falling back to numpy.  stats counts what
went to the device.
"""

from __future__ import annotations

import numpy as np


class ForestArrays:
    """Dense padded representation of a classification forest."""

    def __init__(self, feature, threshold, left, right, prob, max_depth):
        self.feature = feature      # (T, N) int32; -1 for leaves
        self.threshold = threshold  # (T, N) float32
        self.left = left            # (T, N) int32
        self.right = right          # (T, N) int32
        self.prob = prob            # (T, N) float32: P(class 1) at node
        self.max_depth = int(max_depth)

    @classmethod
    def from_sklearn(cls, model):
        """Flatten a fitted sklearn RandomForestClassifier."""
        trees = [est.tree_ for est in model.estimators_]
        T = len(trees)
        N = max(t.node_count for t in trees)
        feature = np.full((T, N), -1, dtype=np.int32)
        threshold = np.zeros((T, N), dtype=np.float32)
        left = np.zeros((T, N), dtype=np.int32)
        right = np.zeros((T, N), dtype=np.int32)
        prob = np.zeros((T, N), dtype=np.float32)
        max_depth = 0
        for t, tr in enumerate(trees):
            n = tr.node_count
            feature[t, :n] = tr.feature
            threshold[t, :n] = tr.threshold
            left[t, :n] = tr.children_left
            right[t, :n] = tr.children_right
            counts = tr.value[:, 0, :]           # (n, n_classes)
            tot = counts.sum(axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                p1 = np.where(tot > 0,
                              counts[:, -1] / np.maximum(tot, 1), 0.0)
            prob[t, :n] = p1
            max_depth = max(max_depth, tr.max_depth)
        return cls(feature, threshold, left, right, prob, max_depth)

    def save(self, path):
        np.savez_compressed(path, feature=self.feature,
                            threshold=self.threshold, left=self.left,
                            right=self.right, prob=self.prob,
                            max_depth=self.max_depth)

    @classmethod
    def load(cls, path):
        z = np.load(path)
        return cls(z["feature"], z["threshold"], z["left"], z["right"],
                   z["prob"], int(z["max_depth"]))


def _predict_numpy(fa: ForestArrays, X):
    T, N = fa.feature.shape
    S = X.shape[0]
    node = np.zeros((T, S), dtype=np.int32)
    tidx = np.arange(T)[:, None]
    for _ in range(fa.max_depth):
        feat = fa.feature[tidx, node]
        leaf = feat < 0
        f = np.maximum(feat, 0)
        xv = X[np.arange(S)[None, :], f]
        go_left = xv <= fa.threshold[tidx, node]
        nxt = np.where(go_left, fa.left[tidx, node], fa.right[tidx, node])
        node = np.where(leaf, node, nxt)
    return fa.prob[tidx, node].mean(axis=0)


_PREDICT = {}

stats = {"forest_dispatches": 0,    # predict_proba calls sent to the device
         "forest_rows": 0}          # rows they scored


def _get_torch_predict(max_depth):
    """The gather descent of _predict_numpy on the port's device, one per
    max_depth: numpy in, numpy out.

    Bit for bit equal to _predict_numpy: `xv <= threshold` is an exact f32
    compare, and the mean over trees is numpy's: the (T, S) leaf
    probabilities are added row by row in tree order in f32 (never a
    torch.sum, whose order on the card differs), and the sum is divided by
    T in f64 and rounded to f32, as np.mean divides by its intp count.  T
    is a tensor on the device: a divisor that is a host scalar makes
    PyTorch multiply by its reciprocal on the card, which rounds
    differently.  Indices are int64 (what indexing takes), converted once a
    call and not once a level."""
    key = max_depth
    if key in _PREDICT:
        return _PREDICT[key]
    import torch

    from ..device import device as port_device

    def predict(feature, threshold, left, right, prob, X):
        dev = port_device()
        T, N = feature.shape
        S, F = X.shape

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype).reshape(-1)

        feat_f = up(feature, torch.int64)
        thr_f = up(threshold, torch.float32)
        left_f = up(left, torch.int64)
        right_f = up(right, torch.int64)
        prob_f = up(prob, torch.float32)
        x_f = up(X, torch.float32)
        tbase = (torch.arange(T, device=dev) * N)[:, None]
        sbase = (torch.arange(S, device=dev) * F)[None, :]
        idx = tbase.expand(T, S).clone()     # flat index of each node
        for _ in range(max_depth):
            feat = feat_f[idx]
            leaf = feat < 0
            xv = x_f[sbase + feat.clamp(min=0)]
            go_left = xv <= thr_f[idx]
            nxt = tbase + torch.where(go_left, left_f[idx], right_f[idx])
            idx = torch.where(leaf, idx, nxt)
        p = prob_f[idx]
        acc = p[0].clone()
        for t in range(1, T):
            acc += p[t]
        out = (acc.to(torch.float64)
               / torch.tensor(T, dtype=torch.float64, device=dev))
        stats["forest_dispatches"] += 1
        stats["forest_rows"] += S
        return out.to(torch.float32).cpu().numpy()

    _PREDICT[key] = predict
    return predict


def predict_proba(fa: ForestArrays, X, use_jax=True):
    """P(class 1) per row of X.  use_jax keeps the JAX package's name: it
    sends 256 rows or more to the port's device."""
    X = np.asarray(X, dtype=np.float32)
    if not use_jax or X.shape[0] < 256:
        return _predict_numpy(fa, X)
    fn = _get_torch_predict(fa.max_depth)
    return fn(fa.feature, fa.threshold, fa.left, fa.right, fa.prob, X)


def synthetic_forest(n_trees=100, max_depth=20, n_features=50,
                     max_nodes=4095, split=0.66, seed=0):
    """A seeded random forest in the dense form, built with numpy alone
    (for hosts without sklearn): the trainer's defaults of 100 trees and
    max_depth 20.  Nodes grow breadth first; the leftmost node of each
    level always splits (room is kept for it), so every tree reaches
    max_depth, and any other node splits with probability `split` while
    the tree has room.
    Features, thresholds (standard normal) and leaf probabilities are
    random."""
    rng = np.random.default_rng(seed)
    T, N = n_trees, max_nodes
    feature = np.full((T, N), -1, dtype=np.int32)
    threshold = np.zeros((T, N), dtype=np.float32)
    left = np.zeros((T, N), dtype=np.int32)
    right = np.zeros((T, N), dtype=np.int32)
    prob = rng.random((T, N)).astype(np.float32)
    for t in range(T):
        depth = [0]
        first = True          # the next node is its level's leftmost
        i = 0
        while i < len(depth):
            d = depth[i]
            room = N if first else N - 2 * max_depth
            if d < max_depth and len(depth) + 2 <= room \
                    and (first or rng.random() < split):
                feature[t, i] = rng.integers(0, n_features)
                threshold[t, i] = rng.standard_normal()
                left[t, i], right[t, i] = len(depth), len(depth) + 1
                depth += [d + 1, d + 1]
            first = i + 1 < len(depth) and depth[i + 1] > d
            i += 1
    return ForestArrays(feature, threshold, left, right, prob, max_depth)


def train_forest(X, y, n_estimators=100, max_depth=20, seed=0):
    """Train via sklearn and convert to the dense form."""
    from sklearn.ensemble import RandomForestClassifier
    model = RandomForestClassifier(n_estimators=n_estimators,
                                   max_depth=max_depth, random_state=seed,
                                   n_jobs=1)
    model.fit(X, y)
    return ForestArrays.from_sklearn(model), model
