"""What decides `correct`: every timed pass's outputs against the plain
reference's, byte for byte, and the cell's stages at work on the card.

The reference (refasm/, a frozen copy of the port's host assembly path
with the card taken out) runs once the window has closed, in a process
of its own, on the same BAMs with the configuration's flags, and writes
what a user would get from the host path.  The port's card modes write
the same bytes, so each compared number is exact and its limit is 0:

- passes_failed: passes that raised;
- files_differing: output files (meta GTF, per-sample GTFs, feature
  CSVs) of the passes whose bytes differ from the reference's, or that
  one side lacks;
- lines_differing: lines of those files that differ at their place;
- bundles_gap: the largest gap between a pass's bundles and the
  reference's;
- stages_idle: passes times the mix's forced stages that did not run on
  the card or not in trust mode: a counter of the mix's `engaged` (a
  stage's dispatches, and the answers of the card the program consumed)
  still 0, or a flag of its `trust` not true; such a pass did not run
  the configuration it claims;
- device_refused: the card's answers that the program's own host check
  refused over the passes (each pair of the mix's `agree`: total less
  agreeing), which the program then recomputes on the host: a pass with
  any did not run its stages on the card as the configuration states;
- drain_rows_differing: rows of the sampled drain dispatches
  (window.DrainSample) whose paths, path weights (bitwise) or path
  counts differ from the plain drain's (drain_ref.py) on the same staged
  rows.  The program checks the drain's path weights against its host
  graph before it uses them and finishes a graph on the host where they
  differ, so a wrong drain never reaches the output bytes; this number,
  and device_refused, are what shows one.  It follows the program from
  its own staged rows, which the output comparison checks end to end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from . import drain_ref
from .spec import BENCH_DIR

LIMITS = {"passes_failed": 0, "files_differing": 0, "lines_differing": 0,
          "bundles_gap": 0, "stages_idle": 0, "device_refused": 0,
          "drain_rows_differing": 0}


def run_reference(lst, out, flags, timeout=300):
    """The reference over lst's cohort into out: {"bundles", "seconds"}."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [BENCH_DIR] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    res = subprocess.run(
        [sys.executable, "-m", "refasm", lst, out, *flags], cwd=BENCH_DIR,
        env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError("the reference exited %d: %s"
                           % (res.returncode, res.stderr[-4000:]))
    return json.loads(res.stdout.strip().splitlines()[-1])


def output_files(d):
    out = set()
    for base, _, files in os.walk(d):
        for f in files:
            out.add(os.path.relpath(os.path.join(base, f), d))
    return out


def compare_dirs(got, want):
    """(files differing or missing on a side, lines differing at their
    place, counting a line one side lacks) of one pass against the
    reference."""
    files = lines = 0
    names = output_files(got) | output_files(want)
    for name in sorted(names):
        a, b = os.path.join(got, name), os.path.join(want, name)
        if not (os.path.exists(a) and os.path.exists(b)):
            files += 1
            path = a if os.path.exists(a) else b
            with open(path, "rb") as fh:
                lines += sum(1 for _ in fh)
            continue
        with open(a, "rb") as fa, open(b, "rb") as fb:
            da, db = fa.read(), fb.read()
        if da == db:
            continue
        files += 1
        la, lb = da.split(b"\n"), db.split(b"\n")
        lines += sum(1 for x, y in zip(la, lb) if x != y) \
            + abs(len(la) - len(lb))
    return files, lines


def stage_misses(p, mix):
    """The mix's forced stages that did not run on the card in pass p, or
    not in trust mode."""
    miss = [k for k in mix.get("engaged", []) if p.stats.get(k, 0) <= 0]
    miss += [k for k in mix.get("trust", []) if p.stats.get(k) is not True]
    return miss


def refused(p, mix):
    """The card's answers the program's host check refused in pass p."""
    return sum(max(0, p.stats.get(total, 0) - p.stats.get(agree, 0))
               for agree, total in mix.get("agree", []))


def drain_rows_differing(batches):
    """(rows differing from the plain drain, rows compared) over the
    sampled drain dispatches."""
    bad = rows = 0
    for W, P, sink, scal, maxp, paths, ws, npaths in batches:
        rp, rw, rn = drain_ref.drain(W, P, sink, scal, maxp)
        for i in range(len(sink)):
            k = int(rn[i])
            same = (int(npaths[i]) == k
                    and np.array_equal(paths[i, :k], rp[i, :k])
                    and np.array_equal(
                        np.asarray(ws[i, :k], dtype=np.float64)
                        .view(np.int64), rw[i, :k].view(np.int64)))
            bad += not same
            rows += 1
    return bad, rows


def judge(passes, ref, ref_dir, mix, drain_batches):
    """({check: value}, passes that failed or differ, drain rows
    compared)."""
    checks = dict.fromkeys(LIMITS, 0)
    bad = 0
    for p in passes:
        if p.error is not None:
            checks["passes_failed"] += 1
            bad += 1
            continue
        files, lines = compare_dirs(p.out, ref_dir)
        checks["files_differing"] += files
        checks["lines_differing"] += lines
        checks["bundles_gap"] = max(checks["bundles_gap"],
                                    abs(p.bundles - ref["bundles"]))
        miss = stage_misses(p, mix)
        checks["stages_idle"] += len(miss)
        no = refused(p, mix)
        checks["device_refused"] += no
        if files or p.bundles != ref["bundles"] or miss or no:
            bad += 1
    checks["drain_rows_differing"], compared = drain_rows_differing(
        drain_batches)
    return checks, bad, compared
