"""The reference tests of the four host modules that nothing on the port's
main path runs (core/filters.py, core/draw.py, core/bridged_bam.py,
utils/stats.py), run against the port's copies: TestFilters of
tests/test_components.py and the draw, binomial and bridged-BAM tests of
tests/test_parity_extras.py, with each answer also held to the JAX
package's."""

import math

import pytest

from aletsch_tpu.core import filters as ref_filters
from aletsch_tpu.utils.stats import \
    compute_binomial_pvalue as ref_binomial_pvalue
from aletsch_tpu_torch.config import Parameters
from aletsch_tpu_torch.core.bridged_bam import (chain_to_cigar,
                                                write_bridged_pereads_cluster)
from aletsch_tpu_torch.core.draw import draw_splice_graph
from aletsch_tpu_torch.core.filters import (join_single_exon_transcripts,
                                            remove_nested_transcripts,
                                            verify_exon_length,
                                            verify_length_coverage)
from aletsch_tpu_torch.core.graph import SpliceGraph, VertexInfo
from aletsch_tpu_torch.io.bam import BamReader, BamWriter
from aletsch_tpu_torch.io.gtf import Transcript
from aletsch_tpu_torch.utils.stats import compute_binomial_pvalue


class TestFilters:
    def mk(self, exons, cov=5.0, strand="+"):
        t = Transcript(seqname="chr1", strand=strand, coverage=cov)
        for a, b in exons:
            t.add_exon(a, b)
        return t

    def test_verify_length_coverage(self):
        cfg = Parameters()
        t = self.mk([(0, 50), (100, 160)], cov=5)
        assert verify_length_coverage(t, cfg) is False  # 110 < 100+2*20
        t2 = self.mk([(0, 100), (200, 300)], cov=5)
        assert verify_length_coverage(t2, cfg) is True
        t3 = self.mk([(0, 100), (200, 300)], cov=1.0)
        assert verify_length_coverage(t3, cfg) is False
        t4 = self.mk([(0, 200)], cov=10)  # single exon, length 200 < 250
        assert verify_length_coverage(t4, cfg) is False
        for t in (t, t2, t3, t4):
            assert ref_filters.verify_length_coverage(t, cfg) is \
                verify_length_coverage(t, cfg)

    def test_verify_exon_length(self):
        cfg = Parameters()
        assert verify_exon_length(self.mk([(0, 100), (105, 113)]), cfg)
        assert not verify_exon_length(self.mk([(0, 100), (105, 112)]), cfg)
        assert ref_filters.verify_exon_length(
            self.mk([(0, 100), (105, 113)]), cfg)

    def test_remove_nested(self):
        big = self.mk([(0, 100), (1000, 1100)], cov=2)
        nested = self.mk([(300, 400), (500, 600)], cov=9)
        out = remove_nested_transcripts([big, nested])
        assert len(out) == 1
        assert out[0] is nested
        assert ref_filters.remove_nested_transcripts([big, nested]) == out

    def test_join_single_exon(self):
        cfg = Parameters()
        multi = self.mk([(0, 100), (200, 300)], cov=5)
        single = self.mk([(350, 500)], cov=5)
        out = join_single_exon_transcripts([multi, single], cfg)
        assert len(out) == 1
        assert out[0].exons[-1] == (200, 500)


def simple_graph():
    gr = SpliceGraph()
    gr.add_vertex()
    gr.set_vertex_info(0, VertexInfo(lpos=0, rpos=0))
    for i, (l, r, w) in enumerate([(0, 100, 10.0), (200, 300, 9.0)]):
        gr.add_vertex()
        gr.set_vertex_info(i + 1, VertexInfo(lpos=l, rpos=r, length=r - l))
        gr.set_vertex_weight(i + 1, w)
    gr.add_vertex()
    gr.set_vertex_info(3, VertexInfo(lpos=300, rpos=300))
    for (s, t, w) in [(0, 1, 10), (1, 2, 9), (2, 3, 9)]:
        e = gr.add_edge(s, t)
        gr.set_edge_weight(e, w)
    return gr


def test_draw(tmp_path):
    gr = simple_graph()
    p = str(tmp_path / "g.tex")
    draw_splice_graph(gr, p)
    s = open(p).read()
    assert "tikzpicture" in s and s.count("\\node") == 4
    assert s.count("\\draw") == 3


@pytest.mark.parametrize("n,p,k", [(10, 0.5, 0), (10, 0.5, 11),
                                   (100, 0.1, 20), (50, 0.3, 12)])
def test_binomial_pvalue(n, p, k):
    got = compute_binomial_pvalue(n, p, k)
    assert got == ref_binomial_pvalue(n, p, k)
    if k == 0:
        assert got == 1.0
    elif k > n:
        assert got == 0.0
    else:
        assert 0.0 < got < 1.0 and not math.isnan(got)
    if (n, p, k) == (100, 0.1, 20):
        assert got < 0.01


def test_chain_to_cigar():
    assert chain_to_cigar(100, [150, 250], 300) == [(0, 50), (3, 100), (0, 50)]
    assert chain_to_cigar(100, [90, 95], 300) is None


def test_bridged_bam_roundtrip(tmp_path):
    class H:
        def __init__(s):
            s.qname = "q1"
            s.flag = 0x1 | 0x40
            s.tid = 0
            s.pos = 1000
            s.rpos = 1100
            s.qual = 60
            s.xs = "+"
            s.nh = 1
            s.hi = -1
            s.mtid = 0
            s.mpos = 1300
            s.isize = 400

    class PC:
        pass

    pc = PC()
    h1 = H()
    h2 = H()
    h2.pos, h2.rpos = 1300, 1400
    pc.hits1 = [h1]
    pc.hits2 = [h2]
    p = str(tmp_path / "b.bam")
    w = BamWriter(p, ["chr1"], [100000])
    n = write_bridged_pereads_cluster(w, pc, [1100, 1300])
    w.close()
    assert n == 1
    r = BamReader(p)
    rec = r.read_rec()
    assert rec.pos == 1000 and rec.rpos == 1400
    assert rec.extract_splices() == [1100, 1300]
    r.close()
