"""Train a transcript-scoring forest from assembled output + truth GTF.

The published Aletsch model is a pre-trained sklearn RandomForest (Zenodo,
README.md:73); this utility re-trains an equivalent model when that file is
unavailable: label every feature row by whether its transcript's intron
chain matches a truth annotation, build the same 50-feature matrix the
scorer uses, fit a forest, and save both joblib and the dense .npz form.

Usage:
  python -m aletsch_tpu_torch.scoring.train -i <gtf_dir> -g <meta.gtf> \
      -t <truth.gtf> -c <n_samples> -o model.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.gtf import read_gtf
from .forest import train_forest
from .score import load_feature_rows


def _chain_key(t):
    return (t.seqname, tuple(t.get_intron_chain()))


def label_rows(input_dir, meta_gtf, truth_gtf, sample_size):
    """(X, y, meta_tids): feature matrix + chain-match labels."""
    truth = {_chain_key(t) for t in read_gtf(truth_gtf) if len(t.exons) >= 2}
    by_tid = {}
    for t in read_gtf(meta_gtf):
        if len(t.exons) >= 2:
            by_tid[t.transcript_id] = _chain_key(t) in truth
    meta, X = load_feature_rows(input_dir, sample_size)
    y = np.array([1 if by_tid.get(tid, False) else 0 for tid in meta],
                 dtype=np.int64)
    return X, y, meta


def train(input_dir, meta_gtf, truth_gtf, sample_size, out_path,
          n_estimators=100, max_depth=20, seed=0):
    X, y, meta = label_rows(input_dir, meta_gtf, truth_gtf, sample_size)
    if len(set(y.tolist())) < 2:
        raise ValueError("training labels are single-class; need both "
                         "matched and unmatched transcripts (%d rows, "
                         "%d positive)" % (len(y), int(y.sum())))
    fa, model = train_forest(X, y, n_estimators=n_estimators,
                             max_depth=max_depth, seed=seed)
    fa.save(out_path)
    try:
        import joblib
        joblib.dump(model, out_path.replace(".npz", ".joblib"))
    except Exception:
        pass
    return fa, model, int(y.sum()), len(y)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the transcript scorer.")
    ap.add_argument("-i", "--input_dir", required=True,
                    help="dir with <sid>.trstFeature.csv files")
    ap.add_argument("-g", "--meta_gtf", required=True)
    ap.add_argument("-t", "--truth_gtf", required=True)
    ap.add_argument("-c", "--count", type=int, required=True)
    ap.add_argument("-o", "--output", required=True, help=".npz model path")
    ap.add_argument("--n_estimators", type=int, default=100)
    ap.add_argument("--max_depth", type=int, default=20)
    args = ap.parse_args(argv)
    try:
        fa, model, pos, tot = train(args.input_dir, args.meta_gtf,
                                    args.truth_gtf, args.count, args.output,
                                    args.n_estimators, args.max_depth)
    except ValueError as e:
        print("error: %s" % e, file=sys.stderr)
        return 1
    print("trained on %d rows (%d positive); model -> %s" %
          (tot, pos, args.output))


if __name__ == "__main__":
    sys.exit(main())
