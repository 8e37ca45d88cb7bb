"""Transcript scoring CLI: feature CSVs -> per-meta-transcript probabilities.

Byte-level re-implementation of the reference score.py pipeline:
- load 0..N.trstFeature.csv (sample N = combined graph, keep count2 == 1)
- normalize count-scaled features by the max observed count2 (score.py:10-49)
- run forest inference over the 50-column feature matrix (score.py:64-83)
- average probability per meta_tid, threshold (default 0.2), write CSV

Accepts either a joblib sklearn model (like the published Zenodo model) or a
converted .npz forest; inference runs through the batched JAX evaluator.

Usage: python -m aletsch_tpu_torch.scoring.score -i dir -m model -c N -o out.csv
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .forest import ForestArrays, predict_proba

CSV_COLUMNS = [
    "tid", "meta_tid", "chr", "cov", "cov2", "abundance", "confidence",
    "count1", "count2", "num_exons", "gr_vertices", "gr_edges", "gr_reads",
    "gr_subgraph", "v", "e", "junc_ratio", "max_mid_exon_len", "start_loss1",
    "start_loss2", "start_loss3", "end_loss1", "end_loss2", "end_loss3",
    "start_merged_loss", "end_merged_loss", "introns", "intron_ratio",
    "start_introns", "start_intron_ratio", "end_introns", "end_intron_ratio",
    "uni_junc", "seq_min_wt", "seq_min_cnt", "seq_min_abd", "seq_min_ratio",
    "seq_max_wt", "seq_max_cnt", "seq_max_abd", "seq_max_ratio", "start_cnt",
    "start_weight", "start_abd", "end_cnt", "end_weight", "end_abd",
    "unbridge_start_coming_count", "unbridge_start_coming_ratio",
    "unbridge_end_leaving_count", "unbridge_end_leaving_ratio",
]

NORMALIZE = [
    "cov", "abundance", "count1", "count2",
    "start_loss1", "end_loss1", "start_loss2", "end_loss2",
    "start_loss3", "end_loss3", "start_merged_loss", "end_merged_loss",
    "seq_min_cnt", "seq_min_abd", "seq_max_cnt", "seq_max_abd",
]

MODEL_FEATURES = [
    "cov", "cov2", "abundance", "confidence", "count1", "count2",
    "num_exons", "gr_vertices", "gr_edges", "v", "e",
    "junc_ratio", "max_mid_exon_len",
    "start_loss1", "end_loss1", "start_loss2", "end_loss2",
    "start_loss3", "end_loss3", "start_merged_loss", "end_merged_loss",
    "introns", "intron_ratio", "start_introns", "end_introns",
    "start_intron_ratio", "end_intron_ratio", "uni_junc",
    "seq_min_wt", "seq_min_cnt", "seq_min_abd", "seq_min_ratio",
    "seq_max_wt", "seq_max_cnt", "seq_max_abd", "seq_max_ratio",
    "meta_only", "sample_size",
    "start_cnt", "start_weight", "start_abd",
    "end_cnt", "end_weight", "end_abd",
    "gr_reads", "gr_subgraph",
    "unbridge_start_coming_count", "unbridge_start_coming_ratio",
    "unbridge_end_leaving_count", "unbridge_end_leaving_ratio",
]


def load_feature_rows(input_dir, sample_size):
    """score.py:10-49; returns (meta_tids, feature matrix)."""
    rows = []
    meta = []
    for i in range(sample_size + 1):
        path = os.path.join(input_dir, "%d.trstFeature.csv" % i)
        if not os.path.exists(path):
            continue
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != len(CSV_COLUMNS):
                    continue
                d = dict(zip(CSV_COLUMNS, parts))
                count2 = float(d["count2"])
                if i == sample_size and count2 != 1:
                    continue
                d["meta_only"] = 1.0 if (i == sample_size and count2 == 1) else 0.0
                d["sample_id"] = float(i)
                d["sample_size"] = float(sample_size)
                rows.append(d)
                meta.append(d["meta_tid"])
    if not rows:
        return [], np.zeros((0, len(MODEL_FEATURES)), dtype=np.float32)
    max_cnt = max(float(r["count2"]) for r in rows)
    X = np.zeros((len(rows), len(MODEL_FEATURES)), dtype=np.float32)
    for ri, r in enumerate(rows):
        for ci, name in enumerate(MODEL_FEATURES):
            v = float(r[name])
            if name in NORMALIZE and max_cnt > 0:
                v /= max_cnt
            X[ri, ci] = v
    return meta, X


def load_model(path):
    if path.endswith(".npz"):
        return ForestArrays.load(path)
    import joblib
    model = joblib.load(path)
    return ForestArrays.from_sklearn(model)


def score(input_dir, model_path, sample_size, output_file, prob_score=0.2):
    fa = load_model(model_path)
    meta, X = load_feature_rows(input_dir, sample_size)
    if len(meta) == 0:
        with open(output_file, "w") as fh:
            fh.write("meta_tid,y_prob_mean\n")
        return
    y = predict_proba(fa, X)
    agg = {}
    for tid, p in zip(meta, y):
        agg.setdefault(tid, []).append(float(p))
    with open(output_file, "w") as fh:
        fh.write("meta_tid,y_prob_mean\n")
        for tid in sorted(agg):
            m = float(np.mean(agg[tid]))
            if m < prob_score:
                continue
            fh.write("%s,%s\n" % (tid, m))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Score transcripts with a pre-trained forest.")
    ap.add_argument("-i", "--input_dir", required=True)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-c", "--count", type=int, required=True)
    ap.add_argument("-o", "--output_file", required=True)
    ap.add_argument("-p", "--prob_score", type=float, default=0.2)
    args = ap.parse_args(argv)
    try:
        score(args.input_dir, args.model, args.count, args.output_file,
              args.prob_score)
    except (OSError, ValueError) as e:
        print("error: cannot load model %s (%s)" % (args.model, e),
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
