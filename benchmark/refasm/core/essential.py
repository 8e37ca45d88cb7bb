"""Core path/coordinate conversions and transcript construction.

Re-implements the free functions of rnacore/essential.{h,cc} used on the
assembly path: vertex-path <-> exon/intron coordinate conversions, strand
checks from intron chains, hit alignment onto the splice graph, transcript
construction from decomposed paths, and child-graph extraction.
"""

from __future__ import annotations

from ..io.gtf import Transcript, gtf_source
from ..utils.seqs import check_increasing
from .graph import SpliceGraph
import math


def get_total_length_of_introns(chain):
    """essential.cc:101-113"""
    x = 0
    for k in range(len(chain) // 2):
        p, q = chain[k * 2], chain[k * 2 + 1]
        assert p < q
        x += q - p
    return x


def build_exon_coordinates_from_path(gr, v):
    """Vertex path -> exon-boundary coordinate list (essential.cc:115-146)."""
    vv = []
    if len(v) == 0:
        return vv
    n = gr.num_vertices() - 1
    pre = -99999
    for p in v:
        if p == 0 or p == n:
            continue
        vi = gr.get_vertex_info(p)
        pp, qq = vi.lpos, vi.rpos
        if pp == pre:
            pre = qq
            continue
        if pre >= 0:
            vv.append(pre)
        vv.append(pp)
        pre = qq
    if pre >= 0:
        vv.append(pre)
    return vv


def build_intron_coordinates_from_path(gr, v):
    """essential.cc:148-162"""
    vv = []
    for i in range(len(v) - 1):
        pp = gr.get_vertex_info(v[i]).rpos
        qq = gr.get_vertex_info(v[i + 1]).lpos
        assert pp <= qq
        if pp == qq:
            continue
        vv.append(pp)
        vv.append(qq)
    return vv


def check_strand_from_intron_coordinates(gr, v):
    """0 unknown / 1 '+' / 2 '-' / -1 invalid (essential.cc:164-200)."""
    assert len(v) % 2 == 0
    if len(v) == 0:
        return 0
    b1 = b2 = False
    for k in range(len(v) // 2):
        p, q = v[2 * k], v[2 * k + 1]
        if p >= q:
            return -1
        if p not in gr.rindex or q not in gr.lindex:
            return -1
        kp = gr.rindex[p]
        kq = gr.lindex[q]
        e = gr.edge(kp, kq)
        if e is None:
            return -1
        strand = gr.get_edge_info(e).strand
        if strand == 1:
            b1 = True
        if strand == 2:
            b2 = True
    if b1 and b2:
        return -1
    if b1:
        return 1
    if b2:
        return 2
    return 0


def check_continuous_vertices(gr, x, y):
    """essential.cc:436-446"""
    if x >= y:
        return True
    for i in range(x, y):
        e = gr.edge(i, i + 1)
        if e is None:
            return False
        if gr.get_vertex_info(i).rpos != gr.get_vertex_info(i + 1).lpos:
            return False
    return True


def check_valid_path(gr, vv):
    """essential.cc:448-459"""
    n = gr.num_vertices() - 1
    for k in range(len(vv) - 1):
        if vv[k] < 0 or vv[k] > n or vv[k + 1] < 0 or vv[k + 1] > n:
            return False
        if gr.edge(vv[k], vv[k + 1]) is None:
            return False
    return True


def build_path_from_exon_coordinates(gr, v):
    """Exon-chain coordinates -> vertex path (essential.cc:321-366)."""
    if len(v) == 0:
        return True, []
    assert len(v) % 2 == 0
    n = len(v) // 2
    pp = []
    for k in range(n):
        p, q = v[2 * k], v[2 * k + 1]
        if p < 0 or q < 0 or p >= q:
            return False, []
        if p not in gr.lindex or q not in gr.rindex:
            return False, []
        pp.append((gr.lindex[p], gr.rindex[q]))
    vv = []
    for a, b in pp:
        if a > b:
            return False, []
        if not check_continuous_vertices(gr, a, b):
            return False, []
        vv.extend(range(a, b + 1))
    for i in range(len(vv) - 1):
        if vv[i] >= vv[i + 1]:
            return False, []
    return True, vv


def build_path_from_intron_coordinates(gr, v):
    """essential.cc:368-403"""
    if len(v) == 0:
        return True, []
    assert len(v) % 2 == 0
    n = len(v) // 2
    pp = []
    for k in range(n):
        p, q = v[2 * k], v[2 * k + 1]
        if p >= q:
            return False, []
        if p not in gr.rindex or q not in gr.lindex:
            return False, []
        pp.append((gr.rindex[p], gr.lindex[q]))
    vv = [pp[0][0]]
    for k in range(n - 1):
        a = pp[k][1]
        b = pp[k + 1][0]
        if a > b:
            return False, []
        if not check_continuous_vertices(gr, a, b):
            return False, []
        vv.extend(range(a, b + 1))
    vv.append(pp[-1][1])
    return True, vv


def build_path_from_mixed_coordinates(gr, v):
    """[start, introns..., end] -> vertex path (essential.cc:405-434)."""
    if len(v) == 0:
        return False, []
    assert len(v) % 2 == 0
    u1 = gr.locate_vertex(v[0])
    u2 = gr.locate_vertex(v[-1] - 1)
    if u1 < 0 or u2 < 0 or u1 > u2:
        return False, []
    if len(v) == 2:
        return True, list(range(u1, u2 + 1))
    ok, uu = build_path_from_intron_coordinates(gr, v[1:-1])
    if not ok:
        return False, []
    vv = list(range(u1, uu[0])) + uu + list(range(uu[-1] + 1, u2 + 1))
    return True, vv


def align_hit_to_splice_graph(hit, chain, gr):
    """essential.cc:461-472"""
    u = [hit.pos] + list(chain) + [hit.rpos]
    if not check_increasing(u):
        return False, []
    return build_path_from_mixed_coordinates(gr, u)


def build_transcript(gr, p, tid, source=None):
    """Decomposed path -> Transcript (essential.cc:719-748)."""
    trst = Transcript()
    trst.seqname = gr.chrm
    trst.source = gtf_source() if source is None else source
    trst.gene_id = gr.gid
    trst.transcript_id = tid
    trst.coverage = math.log(1.0 + p.weight)
    trst.strand = p.strand
    trst.cov2 = trst.coverage
    trst.conf = p.conf
    trst.abd = p.abd
    trst.count1 = p.count
    trst.count2 = 1
    trst.meta_tid = tid
    # union of vertex intervals (join map)
    iv = []
    for k in range(1, len(p.v) - 1):
        vi = gr.get_vertex_info(p.v[k])
        iv.append((vi.lpos, vi.rpos))
    iv.sort()
    merged = []
    for a, b in iv:
        if merged and merged[-1][1] >= a:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for a, b in merged:
        trst.add_exon(a, b)
    return trst


def build_single_exon_transcript(gr, source=None):
    """essential.cc:750-765"""
    if gr.num_vertices() != 3:
        return None
    if gr.edge(0, 1) is None or gr.edge(1, 2) is None:
        return None
    from .paths import Path
    p = Path()
    p.abd = gr.get_vertex_weight(1)
    p.strand = gr.strand
    p.v = [1]
    # reference uses weight=0 here (only abd set); coverage = log(1+0)
    tid = gr.gid + ".0"
    t = build_transcript(gr, p, tid, source)
    return t


def build_child_splice_graph(root: SpliceGraph, a2b: dict):
    """Extract subgraph over vertex subset a2b (essential.cc:16-99)."""
    gr = SpliceGraph()
    if len(a2b) == 0:
        return gr
    vv = sorted(a2b.keys())
    gr.chrm = root.chrm
    gr.strand = root.strand
    lpos = root.get_vertex_info(vv[0]).lpos
    rpos = root.get_vertex_info(vv[-1]).rpos
    gr.add_vertex()
    from .graph import VertexInfo
    gr.set_vertex_info(0, VertexInfo(lpos=lpos, rpos=lpos))
    gr.set_vertex_weight(0, 0)
    for i, k in enumerate(vv):
        gr.add_vertex()
        gr.set_vertex_weight(i + 1, root.get_vertex_weight(k))
        gr.set_vertex_info(i + 1, root.get_vertex_info(k).copy())
    gr.add_vertex()
    gr.set_vertex_info(len(vv) + 1, VertexInfo(lpos=rpos, rpos=rpos))
    gr.set_vertex_weight(len(vv) + 1, 0)
    n = root.num_vertices() - 1
    for e in root.out_edges(0):
        t = e.t
        if t not in a2b:
            continue
        f = gr.add_edge(0, a2b[t])
        gr.set_edge_weight(f, root.get_edge_weight(e))
        gr.set_edge_info(f, root.get_edge_info(e).copy())
    for s in vv:
        x = a2b[s]
        for e in root.out_edges(s):
            t = e.t
            y = gr.num_vertices() - 1 if t == n else a2b[t]
            f = gr.add_edge(x, y)
            gr.set_edge_weight(f, root.get_edge_weight(e))
            gr.set_edge_info(f, root.get_edge_info(e).copy())
    return gr


def transform_vertex_set_map(s):
    """set of root vertices -> {root vertex: child vertex} (util)."""
    return {v: i + 1 for i, v in enumerate(sorted(s))}
