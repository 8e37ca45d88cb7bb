"""The port's CLI (python -m aletsch_tpu_torch, in process on the CPU
device) on the protocol inputs of tests/test_protocols.py and
tests/test_stranded_library.py: long reads (ONT, PacBio CCS and
sub-reads), single-end short reads, a chromosome filter, a mixed
paired-end and ONT list, unpaired reads past max_read_span, hard-clipped
supplementary records and a dUTP (fr_first) library.  Each test makes the
assertions of its counterpart on the port's output, with every device
stage forced on (their plain PyTorch forms), and holds every output file
byte for byte to the JAX package's host run (python -m aletsch_tpu) on the
same input."""

import os
import random

import pytest
import torch

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.constants import FR_FIRST
from aletsch_tpu_torch.io.bam import CHARD, CMATCH, CREF_SKIP, CSOFT
from aletsch_tpu_torch.io.bam_native import native_available
from aletsch_tpu_torch.io.gtf import read_gtf
from aletsch_tpu_torch.meta import device_wave
from aletsch_tpu_torch.meta.incubator import Incubator
from aletsch_tpu_torch.sim import (GENE_A_ISO1, map_to_genome,
                                   simulate_pairs, simulate_sample,
                                   write_bam)
from test_protocols import (ISO_X, ISO_Y, intron_chain, long_read_recs,
                            write_ont_sample)
from torch_helpers import load_reference_native, output_bytes

FORCED = ["--device_greedy", "on", "--device_min_vertices", "2",
          "--device_min_groups", "0", "--device_bridge", "on",
          "--device_support", "on", "--device_ladder", "on",
          "--device_similarity", "on"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    for var in ("ALETSCH_REF_QUIRKS", "ALETSCH_FUSED_TRUST",
                "ALETSCH_DEVICE", "ALETSCH_DEVICE_GREEDY"):
        monkeypatch.delenv(var, raising=False)
    assert load_reference_native() == native_available()


def run(tmp_path, lines, monkeypatch, extra=()):
    """The port's CLI with every stage forced and the JAX package's at its
    host defaults on one bams.list of `lines`: asserts every output file
    equal and returns (the port's transcripts, its Incubator)."""
    bl = tmp_path / "bams.list"
    bl.write_text("".join(lines))
    made = []

    class Recorded(Incubator):
        def __init__(self, params):
            super().__init__(params)
            made.append(self)

    monkeypatch.setattr(port_main, "Incubator", Recorded)
    files = {}
    device_wave.reset_solvers()
    for k in device_wave.stats:
        device_wave.stats[k] = 0
    for side, main, flags in (("ref", ref_main.main, ()),
                              ("port", port_main.main, FORCED)):
        out = tmp_path / side
        (out / "gtf").mkdir(parents=True)
        assert main(["-i", str(bl), "-o", str(out / "meta.gtf"), "-d",
                     str(out / "gtf"), "--verbose", "0", *flags,
                     *extra]) == 0
        files[side] = output_bytes(str(out / "meta.gtf"), str(out / "gtf"))
    assert sorted(files["port"]) == sorted(files["ref"])
    for f in files["ref"]:
        assert files["port"][f] == files["ref"][f], \
            "%s differs from the JAX package's" % f
    assert device_wave.device_stats()["waves"] > 0, "no device wave ran"
    assert len(made) == 1
    return read_gtf(str(tmp_path / "port" / "meta.gtf")), made[0]


def run_ont(tmp_path, monkeypatch, protocol, chrm_filter=""):
    bam = str(tmp_path / "ont.bam")
    write_ont_sample(bam, 5)
    extra = ("-l", chrm_filter) if chrm_filter else ()
    return run(tmp_path, ["%s %s.bai %s\n" % (bam, bam, protocol)],
               monkeypatch, extra)[0]


def test_ont_long_reads(tmp_path, monkeypatch):
    trsts = run_ont(tmp_path, monkeypatch, "ont")
    chains = {(t.seqname, intron_chain(t.exons)) for t in trsts}
    assert ("chr1", intron_chain(ISO_X)) in chains
    assert ("chr2", intron_chain(ISO_Y)) in chains
    by = {t.seqname: t for t in trsts}
    assert by["chr1"].strand == "+"
    assert by["chr2"].strand == "-"


def test_pacbio_ccs(tmp_path, monkeypatch):
    assert len(run_ont(tmp_path, monkeypatch, "pacbio_ccs")) >= 2


def test_chromosome_filter(tmp_path, monkeypatch):
    trsts = run_ont(tmp_path, monkeypatch, "ont", chrm_filter="chr2")
    assert len(trsts) >= 1
    assert all(t.seqname == "chr2" for t in trsts)


def test_pacbio_sub(tmp_path, monkeypatch):
    assert len(run_ont(tmp_path, monkeypatch, "pacbio_sub")) >= 2


def test_single_end(tmp_path, monkeypatch):
    """single_end short reads: unpaired records, strand from XS only."""
    rng = random.Random(9)
    recs = []
    total = sum(b - a for a, b in ISO_X)
    for i in range(120):
        s = rng.randint(0, total - 100)
        g, cigar = map_to_genome(ISO_X, s, 100)
        xs = "+" if any(op == CREF_SKIP for op, _ in cigar) else "."
        flag = 0x10 if rng.random() < 0.5 else 0
        recs.append(dict(qname="s.%d" % i, flag=flag, pos=g, cigar=cigar,
                         mpos=-1, isize=0, xs=xs))
    bam = str(tmp_path / "se.bam")
    write_bam(bam, recs, names=("chr1",), lengths=(10**6,))
    trsts, _ = run(tmp_path, ["%s x single_end\n" % bam], monkeypatch)
    assert intron_chain(ISO_X) in {intron_chain(t.exons) for t in trsts}


def test_mixed_cohort(tmp_path, monkeypatch):
    """paired_end and ont samples in one list: per-sample protocol
    overlays."""
    pe = str(tmp_path / "pe.bam")
    simulate_sample(pe, seed=3, names=("chr1", "chr2"),
                    lengths=(10**6, 10**6))
    lr = str(tmp_path / "lr.bam")
    write_ont_sample(lr, 7)
    trsts, inc = run(tmp_path, ["%s x paired_end\n" % pe, "%s x ont\n" % lr],
                     monkeypatch)
    assert inc.samples[0].data_type != inc.samples[1].data_type
    chains = {(t.seqname, intron_chain(t.exons)) for t in trsts}
    assert ("chr1", intron_chain(ISO_X)) in chains
    assert ("chr2", intron_chain(ISO_Y)) in chains


def test_long_reads_beyond_max_read_span(tmp_path, monkeypatch):
    """Unpaired reads past coordinate max_read_span (~500 kb) survive in the
    default mode (the binary's generator.cc:95 drops them)."""
    iso = [(700000, 700400), (705000, 705300), (710000, 710500)]
    recs = long_read_recs(iso, 15, "+", random.Random(13), "far")
    bam = str(tmp_path / "far.bam")
    write_bam(bam, recs, names=("chr1",), lengths=(2 * 10**6,))
    trsts, _ = run(tmp_path, ["%s x ont\n" % bam], monkeypatch)
    assert intron_chain(iso) in {intron_chain(t.exons) for t in trsts}


def test_hard_clip_and_supplementary_records(tmp_path, monkeypatch):
    """Supplementary (0x800) records with hard and soft clips flow through
    the scan unfiltered."""
    rng = random.Random(8)
    recs = simulate_pairs(GENE_A_ISO1, 50, "+", rng, prefix="n")
    for k in range(10):
        cig = [(CHARD, 20), (CMATCH, 50), (CREF_SKIP, 4700),
               (CMATCH, 40), (CSOFT, 15)]
        recs.append(dict(qname="sup.%d" % k, flag=0x800, pos=10250,
                         cigar=cig, mpos=0, isize=0, xs="+"))
    bam = str(tmp_path / "clip.bam")
    write_bam(bam, recs)
    trsts, _ = run(tmp_path, ["%s x paired_end\n" % bam], monkeypatch)
    assert intron_chain(GENE_A_ISO1) in {intron_chain(t.exons)
                                         for t in trsts}


def test_fr_first_end_to_end(tmp_path, monkeypatch):
    """A dUTP (fr_first) library: inferred from flag/XS agreement, and every
    gene assembled on its own strand."""
    rng = random.Random(13)
    genes = []
    pos = 50000
    for _ in range(12):
        exons = []
        p = pos
        for _ in range(rng.randint(2, 4)):
            el = rng.randint(200, 400)
            exons.append((p, p + el))
            p += el + rng.randint(500, 1200)
        genes.append(exons)
        pos = p + rng.randint(40000, 60000)
    lines = []
    for s in range(2):
        srng = random.Random(60 + s)
        recs = []
        for gi, exons in enumerate(genes):
            recs += simulate_pairs(exons, 60, "+" if gi % 2 == 0 else "-",
                                   srng, prefix="s%dg%d" % (s, gi),
                                   library="fr_first")
        p = str(tmp_path / ("s%d.bam" % s))
        write_bam(p, recs, names=("chr1",), lengths=(10**7,))
        lines.append("%s %s.bai paired_end\n" % (p, p))
    trsts, inc = run(tmp_path, lines, monkeypatch)
    assert inc.samples[0].library_type == FR_FIRST
    assert inc.samples[1].library_type == FR_FIRST
    truth = {intron_chain(g): "+" if gi % 2 == 0 else "-"
             for gi, g in enumerate(genes)}
    found = {intron_chain(t.exons): t.strand for t in trsts
             if len(t.exons) >= 2}
    assert sum(1 for c, s in truth.items() if found.get(c) == s) == \
        len(truth)
