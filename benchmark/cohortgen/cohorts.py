"""Simulated cohorts of BASELINE.json configs 3, 4 and 5, written as
sorted BAMs: a frozen copy of aletsch_tpu_torch/cohorts.py over this
package's simulator (sim.py).

- paired_end_cohort: the production cohort of config 3
  (tools/refbuild/baseline.py::build_cohort): paired-end samples over one
  630 Mb chromosome, gene g at 50 kb + g x 300 kb with 2-7 exons, 10-60
  read pairs a gene; sample s draws from random.Random(seed + s), and at
  the default seed (PAIRED_END_SEED, 77) it writes build_cohort's bytes.
- long_read_cohort: PacBio CCS and ONT samples in turn, full-length
  single-end reads over the gene models of the paired-end production
  cohort (tools/refbuild/baseline.py::build_cohort: gene g at 50 kb + g x
  300 kb, 2-7 exons), 5-30 reads a gene, each trimmed 0-20 bp at both ends
  as the golden harness's long-read samples are
  (tools/refbuild/compare.py::_long_read_sample); sample s draws from
  random.Random(seed + s), LONG_READ_SEED (4000) by default.
- smartseq_cohort: single cells built as the golden smartseq8 cohort
  builds its cells (tools/refbuild/compare.py::cohort_smartseq8): gene
  models from random.Random(90), 2-5 exons from 100 kb on; cell c draws
  from random.Random(seed + c), SMARTSEQ_SEED (91) by default, skips each
  gene with probability 0.55 and otherwise simulates 8-30 read pairs of
  it.  At 25 genes, 8 cells, a 40 Mb chromosome and the default seed it
  writes smartseq8's own bytes.

Each sample is seeded on its own, so the bytes do not depend on how many
processes write them.  Every cohort ends with the sentinel target the
reference binary needs to close its last region (sim.sentinel_target).

The benchmark calls the builders (BUILDERS) with the run's --seed.
"""

from __future__ import annotations

import os
import random

from .sim import map_to_genome, sentinel_target, simulate_pairs, write_bam

PAIRED_END_SEED = 77
PAIRED_END_CHRLEN = 630_000_000
LONG_READ_SEED = 4000
LONG_READ_PROTOCOLS = ("pacbio_ccs", "ont")
LONG_READ_CHRLEN = 630_000_000
SMARTSEQ_SEED = 91
SMARTSEQ_CHRLEN = 100_000_000


def baseline_gene_exons(g):
    """Gene g of the production cohort's gene models
    (tools/refbuild/baseline.py::build_cohort)."""
    off = 50000 + g * 300000
    rng = random.Random(g * 7 + 1)
    exons, p = [], off
    for _ in range(rng.randint(2, 7)):
        el = rng.randint(120, 500)
        exons.append((p, p + el))
        p += el + rng.randint(500, 4000)
    return exons


def smartseq_gene_models(n_genes):
    """The smart-seq cohort's gene models (compare.py::cohort_smartseq8)."""
    rng0 = random.Random(90)
    genes = []
    pos = 100000
    for _ in range(n_genes):
        exons = []
        p = pos
        for _ in range(rng0.randint(2, 5)):
            el = rng0.randint(150, 400)
            exons.append((p, p + el))
            p += el + rng0.randint(400, 2000)
        genes.append(exons)
        pos = p + rng0.randint(25000, 45000)
    return genes


def _paired_end_sample(path, s, n_genes, chrlen, seed):
    rng = random.Random(seed + s)
    recs = []
    for g in range(n_genes):
        depth = rng.randint(10, 60)
        recs += simulate_pairs(baseline_gene_exons(g), depth,
                               "+" if g % 2 == 0 else "-", rng,
                               prefix="s%dg%d" % (s, g))
    n = len(recs)
    recs, names, lengths = sentinel_target(recs, ("chr1",), (chrlen,))
    write_bam(path, recs, names, lengths)
    return n


def _long_read_sample(path, s, n_genes, chrlen, seed):
    rng = random.Random(seed + s)
    recs = []
    for g in range(n_genes):
        exons = baseline_gene_exons(g)
        strand = "+" if g % 2 == 0 else "-"
        total = sum(b - a for a, b in exons)
        for i in range(rng.randint(5, 30)):
            trim_l = rng.randint(0, 20)
            trim_r = rng.randint(0, 20)
            gpos, cigar = map_to_genome(exons, trim_l,
                                        total - trim_l - trim_r)
            recs.append(dict(qname="s%dg%d.%d" % (s, g, i),
                             flag=0x10 if strand == "-" else 0, pos=gpos,
                             cigar=cigar, mpos=-1, isize=0, xs=strand))
    n = len(recs)
    recs, names, lengths = sentinel_target(recs, ("chr1",), (chrlen,))
    write_bam(path, recs, names, lengths)
    return n


def _smartseq_cell(path, c, n_genes, chrlen, seed):
    rng = random.Random(seed + c)
    recs = []
    for gi, exons in enumerate(smartseq_gene_models(n_genes)):
        if rng.random() < 0.55:      # sparse per-cell expression
            continue
        recs += simulate_pairs(exons, rng.randint(8, 30),
                               "+" if gi % 2 == 0 else "-", rng,
                               prefix="c%dg%d" % (c, gi))
    n = len(recs)
    recs, names, lengths = sentinel_target(recs, ("chr1",), (chrlen,))
    write_bam(path, recs, names, lengths)
    return n


_SAMPLE = {"paired_end": _paired_end_sample,
           "long_read": _long_read_sample, "smartseq": _smartseq_cell}


def _write(args):
    kind, *rest = args
    return _SAMPLE[kind](*rest)


def _cohort(kind, base, n_genes, n_samples, chrlen, protocols, name, jobs,
            seed):
    os.makedirs(base, exist_ok=True)
    bams = [os.path.join(base, name % i) for i in range(n_samples)]
    work = [(kind, p, i, n_genes, chrlen, seed) for i, p in enumerate(bams)]
    if jobs > 1 and n_samples > 1:
        import multiprocessing
        with multiprocessing.get_context("spawn").Pool(
                min(jobs, n_samples)) as pool:
            counts = pool.map(_write, work)
    else:
        counts = [_write(w) for w in work]
    lst = os.path.join(base, "bams.list")
    with open(lst, "w") as fh:
        for i, b in enumerate(bams):
            fh.write("%s %s.bai %s\n" % (b, b, protocols[i % len(protocols)]))
    return lst, sum(counts)


def paired_end_cohort(base, n_genes, n_samples, seed=PAIRED_END_SEED,
                      jobs=1):
    """(bams.list, records) of the paired-end production cohort (config 3)
    under base, as tools/refbuild/baseline.py::build_cohort writes it."""
    return _cohort("paired_end", base, n_genes, n_samples, PAIRED_END_CHRLEN,
                   ("paired_end",), "s%d.bam", jobs, seed)


def long_read_cohort(base, n_genes, n_samples, seed=LONG_READ_SEED, jobs=1):
    """(bams.list, records) of the long-read cohort (config 4) under base:
    sample s is pacbio_ccs for even s and ont for odd s."""
    return _cohort("long_read", base, n_genes, n_samples, LONG_READ_CHRLEN,
                   LONG_READ_PROTOCOLS, "lr%d.bam", jobs, seed)


def smartseq_cohort(base, n_genes, n_cells, chrlen=SMARTSEQ_CHRLEN,
                    seed=SMARTSEQ_SEED, jobs=1):
    """(bams.list, records) of the smart-seq cohort (config 5) under base:
    n_cells paired-end cells over n_genes gene models."""
    return _cohort("smartseq", base, n_genes, n_cells, chrlen,
                   ("paired_end",), "cell%d.bam", jobs, seed)


BUILDERS = {"paired_end": paired_end_cohort, "long_read": long_read_cohort,
            "smartseq": smartseq_cohort}

