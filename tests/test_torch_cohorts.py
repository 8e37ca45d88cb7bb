"""The cohort builders of BASELINE.json configs 3, 4 and 5
(aletsch_tpu_torch/cohorts.py), which chip_smoke.py's phase 3i runs at
2000 genes x 10 long-read samples and at 64 cells x 1000 genes: the same
BAM bytes on two calls with the same sizes, whatever the number of
processes that write them; the long-read samples over the production
cohort's own gene models (tools/refbuild/baseline.py), one full-length
read trimmed at most 20 bp at each end a record, in the protocols' turn;
and the smart-seq builder, at the golden smartseq8 cohort's sizes, writing
that cohort's bytes (tools/refbuild/compare.py::cohort_smartseq8)."""

import ast
import os
import random

import pytest

from aletsch_tpu_torch import cohorts
from aletsch_tpu_torch.io.bam import CREF_SKIP, BamReader
from tools.refbuild.compare import COHORTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(bam):
    with BamReader(bam) as rd:
        while True:
            r = rd.read_rec()
            if r is None:
                return
            yield r


def _bytes(lst):
    """[(BAM, index, protocol, BAM bytes)] of a bams.list, paths made
    relative to it."""
    out = []
    base = os.path.dirname(lst)
    for line in open(lst):
        bam, bai, proto = line.split()
        with open(bam, "rb") as fh:
            out.append((os.path.relpath(bam, base), os.path.relpath(
                bai, base), proto, fh.read()))
    return out


@pytest.mark.parametrize("kind,genes,samples", [("long_read", 30, 4),
                                                ("smartseq", 40, 6)])
def test_builders_are_deterministic(kind, genes, samples, tmp_path):
    build = cohorts.BUILDERS[kind]
    lst1, n1 = build(str(tmp_path / "a"), genes, samples)
    lst2, n2 = build(str(tmp_path / "b"), genes, samples, jobs=3)
    assert n1 == n2 > 0
    assert _bytes(lst1) == _bytes(lst2)


def test_smartseq_builder_writes_the_golden_smartseq8_cohort(tmp_path):
    want_dir = str(tmp_path / "golden")
    os.makedirs(want_dir)
    want, protos = COHORTS["smartseq8"](want_dir)
    lst, _ = cohorts.smartseq_cohort(str(tmp_path / "port"), 25, 8,
                                     chrlen=40_000_000)
    got = _bytes(lst)
    assert [g[2] for g in got] == protos
    assert [os.path.basename(p) for p in want] == [g[0] for g in got]
    for path, g in zip(want, got):
        with open(path, "rb") as fh:
            assert fh.read() == g[3], path


def _baseline_gene_exons():
    """gene_exons as tools/refbuild/baseline.py::build_cohort defines it
    (a function nested in build_cohort), compiled from its source."""
    path = os.path.join(REPO, "tools", "refbuild", "baseline.py")
    tree = ast.parse(open(path).read())
    build = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                 and n.name == "build_cohort")
    fn = next(n for n in build.body if isinstance(n, ast.FunctionDef)
              and n.name == "gene_exons")
    scope = {"random": random}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"),
         scope)
    return scope["gene_exons"]


def test_long_read_gene_models_are_the_production_cohorts():
    want = _baseline_gene_exons()
    for g in range(2000):
        assert cohorts.baseline_gene_exons(g) == want(g), g


def test_long_read_samples_hold_full_length_reads(tmp_path):
    genes = 12
    lst, n = cohorts.long_read_cohort(str(tmp_path), genes, 2)
    lines = [ln.split() for ln in open(lst)]
    assert [p for _, _, p in lines] == ["pacbio_ccs", "ont"]
    models = [cohorts.baseline_gene_exons(g) for g in range(genes)]
    seen = 0
    for bam, _, _ in lines:
        per_gene = {}
        for r in _records(bam):
            if r.qname == "sentinel":
                continue
            g = int(r.qname.split("g")[1].split(".")[0])
            exons = models[g]
            per_gene[g] = per_gene.get(g, 0) + 1
            assert r.flag == (0x10 if g % 2 else 0) and r.mpos == -1
            introns = [(op, ln) for op, ln in r.cigar if op == CREF_SKIP]
            # every intron of the model, the read's ends within 20 bp of
            # the model's
            assert len(introns) == len(exons) - 1
            assert 0 <= r.pos - exons[0][0] <= 20
            end = r.pos + sum(ln for op, ln in r.cigar)
            assert 0 <= exons[-1][1] - end <= 20
            seen += 1
        assert sorted(per_gene) == list(range(genes))
        assert all(5 <= c <= 30 for c in per_gene.values())
    assert seen == n


def test_paired_end_builder_writes_the_production_cohort(tmp_path):
    """paired_end_cohort at its default seed writes the bytes of
    tools/refbuild/baseline.py::build_cohort, whose cohort the JAX
    package's bench runs."""
    from tools.refbuild.baseline import build_cohort
    want, n_want = build_cohort(str(tmp_path / "ref"), 5, 2)
    got, n_got = cohorts.paired_end_cohort(str(tmp_path / "port"), 5, 2,
                                           jobs=2)
    assert n_got == n_want > 0
    assert _bytes(got) == _bytes(want)


# sha256 of the BAM bytes, in list order, of each builder at its default
# seed, taken from the builders before they took a seed
DEFAULT_BYTES = {
    ("paired_end", 6, 2):
        "188169105836f8cec2fc5e2c47b20f8703eaa2a8e8af3598d9c1b1b498ab58f3",
    ("long_read", 6, 2):
        "8de081d3a8abb7812a2cb6bbda0ecf2b3a8a7f263c01f95845b6865bd0f4553b",
    ("smartseq", 10, 3):
        "d2484e94e659482e9c3ad220737fee8d44fff194af6fbfb50d8382959ccaacfd"}


def _sha(lst):
    import hashlib
    h = hashlib.sha256()
    for _, _, _, data in _bytes(lst):
        h.update(data)
    return h.hexdigest()


@pytest.mark.parametrize("kind,genes,samples", sorted(DEFAULT_BYTES))
def test_builders_take_a_seed(kind, genes, samples, tmp_path):
    build = cohorts.BUILDERS[kind]
    default, _ = build(str(tmp_path / "default"), genes, samples)
    assert _sha(default) == DEFAULT_BYTES[kind, genes, samples]
    a, n_a = build(str(tmp_path / "a"), genes, samples, seed=1234)
    b, n_b = build(str(tmp_path / "b"), genes, samples, seed=1234, jobs=2)
    c, _ = build(str(tmp_path / "c"), genes, samples, seed=1235)
    assert n_a == n_b > 0
    assert _bytes(a) == _bytes(b)
    assert _sha(a) != _sha(c) and _sha(a) != _sha(default)
