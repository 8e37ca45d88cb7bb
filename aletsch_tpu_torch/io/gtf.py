"""Transcript model, GTF I/O and the 51-column feature table.

Mirrors the reference transcript record (gtf/transcript.{h,cc}): exon chain,
coverage attributes (cov/cov2/abd/conf/count1/count2/meta_tid), the ~40-field
TrstFeatures struct feeding the random-forest scorer, intron-chain hashing and
the single-exon-overlap-aware comparator driving transcript_set merging.

GTF output is byte-compatible with transcript::write (transcript.cc:318-360);
the feature CSV matches write_features column order (transcript.cc:362-428).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.seqs import vector_hash


@dataclass
class TrstFeatures:
    """Per-transcript RF features (gtf/transcript.h:61-104)."""
    gr_vertices: int = 0
    gr_edges: int = 0
    gr_reads: int = 0
    gr_subgraph: int = 0
    num_vertices: int = 0
    num_edges: int = 0
    junc_ratio: float = 0.0
    max_mid_exon_len: int = 0
    start_loss1: float = 0.0
    start_loss2: float = 0.0
    start_loss3: float = 0.0
    end_loss1: float = 0.0
    end_loss2: float = 0.0
    end_loss3: float = 0.0
    start_merged_loss: float = 0.0
    end_merged_loss: float = 0.0
    introns: int = 0
    start_introns: int = 0
    end_introns: int = 0
    intron_ratio: float = 0.0
    start_intron_ratio: float = 0.0
    end_intron_ratio: float = 0.0
    uni_junc: int = 0
    seq_min_wt: float = 0.0
    seq_min_cnt: int = 0
    seq_min_abd: float = 0.0
    seq_min_ratio: float = 0.0
    seq_max_wt: float = 0.0
    seq_max_cnt: int = 0
    seq_max_abd: float = 0.0
    seq_max_ratio: float = 0.0
    unbridge_start_coming_count: int = 0
    unbridge_start_coming_ratio: float = 0.0
    unbridge_end_leaving_count: int = 0
    unbridge_end_leaving_ratio: float = 0.0
    start_cnt: int = 0
    start_weight: float = 0.0
    start_abd: float = 0.0
    end_cnt: int = 0
    end_weight: float = 0.0
    end_abd: float = 0.0


# feature CSV column order after the 10 leading id/coverage columns
# (transcript.cc:374-424)
FEATURE_COLUMNS = [
    "gr_vertices", "gr_edges", "gr_reads", "gr_subgraph", "num_vertices",
    "num_edges", "junc_ratio", "max_mid_exon_len",
    "start_loss1", "start_loss2", "start_loss3",
    "end_loss1", "end_loss2", "end_loss3",
    "start_merged_loss", "end_merged_loss",
    "introns", "intron_ratio", "start_introns", "start_intron_ratio",
    "end_introns", "end_intron_ratio", "uni_junc",
    "seq_min_wt", "seq_min_cnt", "seq_min_abd", "seq_min_ratio",
    "seq_max_wt", "seq_max_cnt", "seq_max_abd", "seq_max_ratio",
    "start_cnt", "start_weight", "start_abd",
    "end_cnt", "end_weight", "end_abd",
    "unbridge_start_coming_count", "unbridge_start_coming_ratio",
    "unbridge_end_leaving_count", "unbridge_end_leaving_ratio",
]


def _fmt(v, prec):
    if isinstance(v, float):
        return ("%." + str(prec) + "f") % v
    return str(v)


import operator as _operator
import os as _os


def gtf_source():
    """GTF `source` column: ours by default; ALETSCH_REF_QUIRKS=1 emits
    the reference's "aletsch" so golden diffs (tools/refbuild/compare.py)
    can be byte-level."""
    if _os.environ.get("ALETSCH_REF_QUIRKS") == "1":
        return "aletsch"
    return "aletsch-tpu"
_FEATURE_GETTER = _operator.attrgetter(*FEATURE_COLUMNS)

# feature columns that are ints in TrstFeatures (vertex_info.cc /
# transcript.h:60-103 integer members); the CSV writer prints them as C++
# `<< int` does
FEATURE_INT_COLUMNS = {
    "gr_vertices", "gr_edges", "gr_reads", "gr_subgraph", "num_vertices",
    "num_edges", "max_mid_exon_len", "introns", "start_introns",
    "end_introns", "uni_junc", "seq_min_cnt", "seq_max_cnt", "start_cnt",
    "end_cnt", "unbridge_start_coming_count", "unbridge_end_leaving_count",
}
_FEATURE_IS_INT = [name in FEATURE_INT_COLUMNS for name in FEATURE_COLUMNS]
# one-shot row formats for write_features (feat_row fast path)
_ROW_HEAD_FMT = "%s\t%s\t%s\t%.6g\t%.6g\t%.6g\t%.6g\t%d\t%d\t%d\t"
_FEAT_ROW_FMT = "\t".join("%d" if isint else "%.6g"
                          for isint in _FEATURE_IS_INT) + "\n"


@dataclass
class Transcript:
    seqname: str = ""
    source: str = ""
    feature: str = ""
    gene_id: str = ""
    transcript_id: str = ""
    gene_type: str = ""
    transcript_type: str = ""
    start: int = 0
    end: int = 0
    score: float = 0.0
    strand: str = "."
    frame: int = -1
    coverage: float = 0.0
    RPKM: float = 0.0
    FPKM: float = 0.0
    TPM: float = 0.0
    meta_tid: str = ""
    cov2: float = 0.0
    conf: float = 0.0
    abd: float = 0.0
    count1: int = 0
    count2: int = 0
    features: TrstFeatures = field(default_factory=TrstFeatures)
    exons: list = field(default_factory=list)   # list of (start, end)
    # raw feature row (FEATURE_COLUMNS order) from the native core; when
    # set, write_features formats it directly and the TrstFeatures dict
    # is never materialized (the merge/replay hot path)
    feat_row: list = None

    # ------------------------------------------------------------- structure
    def clone(self):
        """Independent copy (exons are immutable pairs; features are flat).
        __new__ + __dict__ copy instead of copy.copy: skips the
        __reduce_ex__ protocol machinery on the merge hot path
        (transcript_set TransItem per-sample copies, one per replayed
        transcript at production scale)."""
        t = Transcript.__new__(Transcript)
        d = t.__dict__
        d.update(self.__dict__)
        f = self.features
        if f is not None:
            import copy as _copy
            d["features"] = _copy.copy(f)
        d["exons"] = list(self.exons)
        return t

    def add_exon(self, s, t):
        self.exons.append((int(s), int(t)))

    def sort(self):
        self.exons.sort()

    def shrink(self):
        """Merge touching exons (transcript.cc:111-133)."""
        if not self.exons:
            return
        v = []
        p = list(self.exons[0])
        for q in self.exons[1:]:
            if p[1] == q[0]:
                p[1] = q[1]
            else:
                v.append(tuple(p))
                p = list(q)
        v.append(tuple(p))
        self.exons = v

    def length(self):
        return sum(b - a for a, b in self.exons)

    def get_bounds(self):
        if not self.exons:
            return (-1, -1)
        return (self.exons[0][0], self.exons[-1][1])

    def get_intron_chain(self):
        v = []
        for k in range(1, len(self.exons)):
            v.append((self.exons[k - 1][1], self.exons[k][0]))
        return v

    def get_intron_chain_hashing(self):
        """transcript.cc:183-201"""
        if len(self.exons) == 0:
            return 0
        if len(self.exons) == 1:
            return (self.exons[0][0] + self.exons[0][1]) // 10000 + 1
        vv = []
        for a, b in self.get_intron_chain():
            vv.append(a)
            vv.append(b)
        return vector_hash(vv) + 1

    def extend_bounds(self, t: "Transcript"):
        if not self.exons:
            return
        if t.exons[0][0] < self.exons[0][0]:
            self.exons[0] = (t.exons[0][0], self.exons[0][1])
        if t.exons[-1][1] > self.exons[-1][1]:
            self.exons[-1] = (self.exons[-1][0], t.exons[-1][1])

    # ------------------------------------------------------------ comparison
    def intron_chain_match(self, t: "Transcript") -> bool:
        """transcript.cc:203-216"""
        if len(self.exons) != len(t.exons) or len(self.exons) <= 1:
            return False
        n = len(self.exons) - 1
        if self.exons[0][1] != t.exons[0][1]:
            return False
        if self.exons[n][0] != t.exons[n][0]:
            return False
        for k in range(1, n - 1):
            if self.exons[k] != t.exons[k]:
                return False
        return True

    def intron_chain_compare(self, t: "Transcript") -> int:
        """transcript.cc:218-237"""
        if len(self.exons) < len(t.exons):
            return +1
        if len(self.exons) > len(t.exons):
            return -1
        if len(self.exons) <= 1:
            return 0
        n = len(self.exons) - 1
        if self.exons[0][1] < t.exons[0][1]:
            return +1
        if self.exons[0][1] > t.exons[0][1]:
            return -1
        for k in range(1, n - 1):
            for a, b in ((self.exons[k][0], t.exons[k][0]),
                         (self.exons[k][1], t.exons[k][1])):
                if a < b:
                    return +1
                if a > b:
                    return -1
        if self.exons[n][0] < t.exons[n][0]:
            return +1
        if self.exons[n][0] > t.exons[n][0]:
            return -1
        return 0

    def equal1(self, t: "Transcript", single_exon_overlap: float) -> bool:
        """transcript.cc:239-267"""
        if len(self.exons) != len(t.exons):
            return False
        if self.seqname != t.seqname:
            return False
        if self.strand == "+" and t.strand == "-":
            return False
        if self.strand == "-" and t.strand == "+":
            return False
        if len(self.exons) == 1:
            p2 = max(self.exons[0][0], t.exons[0][0])
            q2 = min(self.exons[0][1], t.exons[0][1])
            overlap = q2 - p2
            if overlap >= single_exon_overlap * self.length():
                return True
            if overlap >= single_exon_overlap * t.length():
                return True
            return False
        return self.intron_chain_match(t)

    def compare1(self, t: "Transcript", single_exon_overlap: float) -> int:
        """transcript.cc:269-300"""
        if len(self.exons) < len(t.exons):
            return +1
        if len(self.exons) > len(t.exons):
            return -1
        if self.seqname < t.seqname:
            return +1
        if self.seqname > t.seqname:
            return -1
        if self.strand < t.strand:
            return +1
        if self.strand > t.strand:
            return -1
        if len(self.exons) == 1:
            p2 = max(self.exons[0][0], t.exons[0][0])
            q2 = min(self.exons[0][1], t.exons[0][1])
            overlap = q2 - p2
            if overlap >= single_exon_overlap * self.length():
                return 0
            if overlap >= single_exon_overlap * t.length():
                return 0
            if self.exons[0][0] < t.exons[0][0]:
                return +1
            if self.exons[0][0] > t.exons[0][0]:
                return -1
            if self.exons[0][1] < t.exons[0][1]:
                return +1
            if self.exons[0][1] > t.exons[0][1]:
                return -1
        return self.intron_chain_compare(t)

    # ----------------------------------------------------------------- output
    def write(self, fout, cov2=-1.0, count=-1):
        """GTF writer (transcript.cc:318-360); 4-decimal fixed precision."""
        if not self.exons:
            return
        p1, p2 = self.get_bounds()
        attrs = 'gene_id "%s"; transcript_id "%s"; ' % (self.gene_id, self.transcript_id)
        if self.gene_type:
            attrs += 'gene_type "%s"; ' % self.gene_type
        if self.transcript_type:
            attrs += 'transcript_type "%s"; ' % self.transcript_type
        attrs += 'cov "%.4f"; ' % self.coverage
        if cov2 >= -0.5:
            attrs += 'cov2 "%.4f"; ' % cov2
        if count >= -0.5:
            attrs += 'count "%d"; ' % count
        parts = ["%s\t%s\ttranscript\t%d\t%d\t%d\t%s\t.\t%s\n" %
                 (self.seqname, self.source, p1 + 1, p2, 1000, self.strand,
                  attrs)]
        for k, (a, b) in enumerate(self.exons):
            parts.append(
                '%s\t%s\texon\t%d\t%d\t%d\t%s\t.\tgene_id "%s"; '
                'transcript_id "%s"; exon "%d"; \n' %
                (self.seqname, self.source, a + 1, b, 1000, self.strand,
                 self.gene_id, self.transcript_id, k + 1))
        fout.write("".join(parts))

    def write_features(self, fout):
        """51-column tab-separated feature row (transcript.cc:362-428).

        Floats use C++ `ostream << double` default formatting (6
        significant digits, general form) -- byte-compatible with the
        reference binary's CSVs, which the published Zenodo RF model was
        trained on (score.py reads these columns).  One %-tuple format per
        row segment instead of ~51 per-column format calls (this is the
        hot line of the output phase at production scale; %d on a float
        truncates toward zero exactly like the previous int() cast)."""
        if self.feat_row is not None:
            fout.write(_ROW_HEAD_FMT % (
                self.transcript_id, self.meta_tid, self.seqname,
                self.coverage, self.cov2, self.abd, self.conf,
                self.count1, self.count2, len(self.exons)))
            fout.write(_FEAT_ROW_FMT % tuple(self.feat_row))
            return
        fmt = "%.6g"
        cols = [self.transcript_id, self.meta_tid, self.seqname,
                fmt % self.coverage, fmt % self.cov2,
                fmt % self.abd, fmt % self.conf,
                str(self.count1), str(self.count2), str(len(self.exons))]
        cols += [(fmt % v) if isinstance(v, float) else str(v)
                 for v in _FEATURE_GETTER(self.features)]
        fout.write("\t".join(cols) + "\n")


# ------------------------------------------------------------------ GTF input

def parse_gtf_line(line):
    """One GTF line -> dict (gtf/item.{h,cc})."""
    if line.startswith("#"):
        return None
    parts = line.rstrip("\n").split("\t")
    if len(parts) < 9:
        return None
    d = {
        "seqname": parts[0], "source": parts[1], "feature": parts[2],
        "start": int(parts[3]) - 1, "end": int(parts[4]),
        "strand": parts[6],
    }
    for kv in parts[8].split(";"):
        kv = kv.strip()
        if not kv:
            continue
        sp = kv.split(" ", 1)
        if len(sp) != 2:
            continue
        d[sp[0]] = sp[1].strip('"')
    return d


def read_gtf(path):
    """Load transcripts from a GTF file (genome::read, gtf/genome.cc)."""
    trsts = {}
    with open(path) as fh:
        for line in fh:
            it = parse_gtf_line(line)
            if it is None:
                continue
            tid = it.get("transcript_id", "")
            if not tid:
                continue
            if it["feature"] == "transcript":
                t = trsts.get(tid)
                if t is None:
                    t = Transcript()
                    trsts[tid] = t
                t.seqname = it["seqname"]
                t.source = it["source"]
                t.gene_id = it.get("gene_id", "")
                t.transcript_id = tid
                t.strand = it["strand"]
                # coverage attribute aliases per the reference reader
                # (gtf/item.cc:66-69): cov/coverage/expression/expr
                t.coverage = float(it.get("cov") or it.get("coverage")
                                   or it.get("expression")
                                   or it.get("expr") or 0)
            elif it["feature"] == "exon":
                t = trsts.get(tid)
                if t is None:
                    t = Transcript(seqname=it["seqname"], source=it["source"],
                                   gene_id=it.get("gene_id", ""),
                                   transcript_id=tid, strand=it["strand"])
                    trsts[tid] = t
                t.add_exon(it["start"], it["end"])
    out = list(trsts.values())
    for t in out:
        t.sort()
    return out


def write_gtf(path, trsts, mode="w"):
    """Write transcripts to a GTF file (genome::write, gtf/genome.cc)."""
    with open(path, mode) as fout:
        for t in trsts:
            t.write(fout)


class Gene:
    """Transcripts grouped by gene_id (gtf/gene.{h,cc})."""

    def __init__(self, gene_id=""):
        self.gene_id = gene_id
        self.transcripts = []

    def add_transcript(self, t):
        self.transcripts.append(t)

    def get_bounds(self):
        lo, hi = 1 << 62, -1
        for t in self.transcripts:
            a, b = t.get_bounds()
            lo = min(lo, a)
            hi = max(hi, b)
        return (lo, hi)


def group_genes(trsts):
    genes = {}
    for t in trsts:
        g = genes.get(t.gene_id)
        if g is None:
            g = Gene(t.gene_id)
            genes[t.gene_id] = g
        g.add_transcript(t)
    return list(genes.values())
