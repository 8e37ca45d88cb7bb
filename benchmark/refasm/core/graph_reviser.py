"""Splice-graph revision passes.

Re-implements the on-path free functions of rnacore/graph_reviser.{h,cc}:
- refine_splice_graph (in core.graph_builder)
- group_start/end_boundaries: merge nearby source/sink edges along continuous
  vertex runs, re-adding weights (graph_reviser.cc:916-1066)
- identify_boundaries: add missing source/sink edges where the log-coverage
  ratio is strong (graph_reviser.cc:1068-1208)
- remove_false_boundaries: stamp unbridge_* features from still-unbridged
  fragments (graph_reviser.cc:1285-1377)
"""

from __future__ import annotations

import math

from .essential import check_continuous_vertices
from .graph import EdgeInfo


def group_start_boundaries(gr, max_dist):
    """graph_reviser.cc:916-995; returns smap {lpos -> grouped lpos}."""
    smap = {}
    v = sorted(e.t for e in gr.out_edges(0))
    if len(v) <= 1:
        return smap
    p1 = gr.get_vertex_info(v[0]).lpos
    p2 = p1
    k1 = v[0]
    k2 = k1
    pa = gr.edge(0, v[0])
    wa = gr.get_edge_weight(pa)
    ea = gr.get_edge_info(pa)
    for i in range(1, len(v)):
        p = gr.get_vertex_info(v[i]).lpos
        pb = gr.edge(0, v[i])
        wb = gr.get_edge_weight(pb)
        eb = gr.get_edge_info(pb)
        b = check_continuous_vertices(gr, k2, v[i])
        if p - p2 > max_dist:
            b = False
        if not b:
            p1 = p2 = p
            k1 = k2 = v[i]
            pa, wa, ea = pb, wb, eb
        else:
            smap[p] = p1
            for j in range(k1, v[i]):
                pc = gr.edge(j, j + 1)
                gr.set_vertex_weight(j, gr.get_vertex_weight(j) + wb)
                ec = gr.get_edge_info(pc)
                ec.count += eb.count
                ec.weight += eb.weight
                gr.set_edge_weight(pc, gr.get_edge_weight(pc) + wb)
            wa += wb
            ea.count += eb.count
            ea.weight += eb.weight
            gr.set_edge_weight(pa, wa)
            gr.remove_edge(pb)
            k2 = v[i]
            p2 = p
    return smap


def group_end_boundaries(gr, max_dist):
    """graph_reviser.cc:997-1066; returns tmap {rpos -> grouped rpos}."""
    tmap = {}
    n = gr.num_vertices() - 1
    v = sorted((e.s for e in gr.in_edges(n)), reverse=True)
    if len(v) <= 1:
        return tmap
    p1 = gr.get_vertex_info(v[0]).rpos
    p2 = p1
    k1 = v[0]
    k2 = k1
    pa = gr.edge(v[0], n)
    wa = gr.get_edge_weight(pa)
    for i in range(1, len(v)):
        p = gr.get_vertex_info(v[i]).rpos
        pb = gr.edge(v[i], n)
        wb = gr.get_edge_weight(pb)
        b = check_continuous_vertices(gr, v[i], k2)
        if p2 - p > max_dist:
            b = False
        if not b:
            p1 = p2 = p
            k1 = k2 = v[i]
            pa, wa = pb, wb
        else:
            tmap[p] = p1
            for j in range(v[i], k1):
                pc = gr.edge(j, j + 1)
                wc = gr.get_edge_weight(pc)
                gr.set_edge_weight(pc, wc + wb)
                gr.set_vertex_weight(j + 1, wc + wb)
            wa += wb
            gr.set_edge_weight(pa, wa)
            gr.remove_edge(pb)
            k2 = v[i]
            p2 = p
    return tmap


def identify_boundaries(gr, cfg):
    """graph_reviser.cc:1068-1077"""
    while True:
        b1 = _identify_start_boundary(gr, cfg.min_boundary_log_ratio)
        b2 = _identify_end_boundary(gr, cfg.min_boundary_log_ratio)
        if not b1 and not b2:
            break


def _identify_start_boundary(gr, min_ratio):
    """graph_reviser.cc:1079-1115"""
    besta = -1
    bestr = 0.0
    bestw = 0.0
    for x in range(1, gr.num_vertices() - 1):
        a = _left_continuous_extend(gr, x)
        b = x
        if a < 0 or b < 0 or a > b:
            continue
        f, maxcov, in_sum = _determine_start_boundary(gr, a, b)
        if f < 0:
            continue
        r = math.log(2 + maxcov) / math.log(2 + in_sum)
        if r < bestr:
            continue
        bestr = r
        besta = a
        bestw = maxcov - in_sum
    if besta < 0 or bestr < min_ratio:
        return False
    ee = gr.add_edge(0, besta)
    gr.set_edge_weight(ee, bestw)
    gr.set_edge_info(ee, EdgeInfo())
    return True


def _identify_end_boundary(gr, min_ratio):
    """graph_reviser.cc:1117-1153"""
    bestb = -1
    bestr = 0.0
    bestw = 0.0
    for x in range(1, gr.num_vertices() - 1):
        a = x
        b = _right_continuous_extend(gr, x)
        if a < 0 or b < 0 or a > b:
            continue
        f, maxcov, out_sum = _determine_end_boundary(gr, a, b)
        if f < 0:
            continue
        r = math.log(2 + maxcov) / math.log(2 + out_sum)
        if r < bestr:
            continue
        bestr = r
        bestb = b
        bestw = maxcov - out_sum
    if bestb < 0 or bestr < min_ratio:
        return False
    ee = gr.add_edge(bestb, gr.num_vertices() - 1)
    gr.set_edge_weight(ee, bestw)
    gr.set_edge_info(ee, EdgeInfo())
    return True


def _determine_start_boundary(gr, a, b):
    """graph_reviser.cc:1155-1181"""
    maxcov = 0.0
    in_sum = 0.0
    for k in range(a, b + 1):
        if gr.edge(0, k) is not None:
            return -1, 0, 0
        maxcov = max(maxcov, gr.get_vertex_weight(k))
        for e in gr.in_edges(k):
            v = e.s
            if a <= v <= b:
                continue
            in_sum += gr.get_edge_weight(e)
    return 0, maxcov, in_sum


def _determine_end_boundary(gr, a, b):
    """graph_reviser.cc:1183-1208"""
    maxcov = 0.0
    out_sum = 0.0
    n = gr.num_vertices() - 1
    for k in range(a, b + 1):
        if gr.edge(k, n) is not None:
            return -1, 0, 0
        maxcov = max(maxcov, gr.get_vertex_weight(k))
        for e in gr.out_edges(k):
            v = e.t
            if a <= v <= b:
                continue
            out_sum += gr.get_edge_weight(e)
    return 0, maxcov, out_sum


def _left_continuous_extend(gr, x):
    """graph_reviser.cc:1210-1230"""
    z = -1
    k = x
    fb = set()
    while True:
        if k <= 0 or k in fb:
            break
        z = k
        _add_distant_in_vertices(gr, k, fb)
        if k - 1 <= 0:
            break
        if gr.edge(k - 1, k) is None:
            break
        if gr.get_vertex_info(k - 1).rpos != gr.get_vertex_info(k).lpos:
            break
        k -= 1
    return z


def _right_continuous_extend(gr, x):
    """graph_reviser.cc:1232-1253"""
    z = -1
    k = x
    fb = set()
    n = gr.num_vertices() - 1
    while True:
        if k >= n or k in fb:
            break
        z = k
        _add_distant_out_vertices(gr, k, fb)
        if k + 1 >= n:
            break
        if gr.edge(k, k + 1) is None:
            break
        if gr.get_vertex_info(k + 1).lpos != gr.get_vertex_info(k).rpos:
            break
        k += 1
    return z


def _add_distant_in_vertices(gr, x, s):
    p = gr.get_vertex_info(x).lpos
    for e in gr.in_edges(x):
        if gr.get_vertex_info(e.s).rpos == p:
            continue
        s.add(e.s)


def _add_distant_out_vertices(gr, x, s):
    p = gr.get_vertex_info(x).rpos
    for e in gr.out_edges(x):
        if gr.get_vertex_info(e.t).lpos == p:
            continue
        s.add(e.t)


def remove_false_boundaries(gr, bb, cfg):
    """graph_reviser.cc:1285-1377: stamp unbridge_* vertex features using
    still-unbridged fragments."""
    fb1 = {}
    fb2 = {}
    for f in bb.frgs:
        if f[2] != 0:
            continue
        h1 = bb.hits[f[0]]
        h2 = bb.hits[f[1]]
        u1 = gr.locate_vertex(h1.rpos - 1)
        u2 = gr.locate_vertex(h2.pos)
        if u1 < 0 or u2 < 0 or u1 >= u2:
            continue
        fb1[u1] = fb1.get(u1, 0) + 1
        fb2[u2] = fb2.get(u2, 0) + 1
    n = gr.num_vertices() - 1
    for x, cnt in fb1.items():
        if gr.edge(x, n) is None:
            continue
        vi = gr.get_vertex_info(x)
        w = gr.get_vertex_weight(x)
        s = math.log(1 + cnt + w) - math.log(1 + w)
        vi.unbridge_leaving_count = cnt
        vi.unbridge_leaving_ratio = s
    for x, cnt in fb2.items():
        if gr.edge(0, x) is None:
            continue
        vi = gr.get_vertex_info(x)
        w = gr.get_vertex_weight(x)
        s = math.log(1 + cnt + w) - math.log(1 + w)
        vi.unbridge_coming_count = cnt
        vi.unbridge_coming_ratio = s


# --------------------------------------------------------------------------
# Full revision pass (graph_reviser.cc:20-469): the alternate whole-graph
# surgery family from the combined-graph era, kept as a library capability.
# --------------------------------------------------------------------------

def revise_splice_graph_full(gr, cfg):
    """graph_reviser.cc:20-58"""
    from .graph_builder import refine_splice_graph
    refine_splice_graph(gr)
    while True:
        if extend_boundaries(gr):
            continue
        if remove_inner_boundaries(gr):
            continue
        if remove_small_exons(gr, cfg.min_exon_length):
            refine_splice_graph(gr)
            continue
        if remove_small_junctions(gr):
            refine_splice_graph(gr)
            continue
        if keep_surviving_edges(gr, cfg.min_surviving_edge_weight):
            refine_splice_graph(gr)
            continue
        if remove_intron_contamination(gr, cfg.max_intron_contamination_coverage):
            continue
        break
    refine_splice_graph(gr)


def revise_splice_graph(gr, cfg):
    """graph_reviser.cc:60-78"""
    from .graph_builder import refine_splice_graph
    refine_splice_graph(gr)
    while keep_surviving_edges(gr, cfg.min_surviving_edge_weight):
        refine_splice_graph(gr)
    refine_splice_graph(gr)


def extend_boundaries(gr):
    """Split weak gap edges into start/end boundaries
    (graph_reviser.cc:80-123)."""
    n = gr.num_vertices() - 1
    for e in gr.edges():
        s, t = e.s, e.t
        p = gr.get_vertex_info(t).lpos - gr.get_vertex_info(s).rpos
        we = gr.get_edge_weight(e)
        ws = gr.get_vertex_weight(s)
        wt = gr.get_vertex_weight(t)
        if p <= 0 or s == 0 or t == n:
            continue
        b = False
        if gr.out_degree(s) == 1 and ws >= 10.0 * we * we + 10.0:
            b = True
        if gr.in_degree(t) == 1 and wt >= 10.0 * we * we + 10.0:
            b = True
        if not b:
            continue
        if gr.out_degree(s) == 1:
            ee = gr.add_edge(s, n)
            gr.set_edge_weight(ee, ws)
        if gr.in_degree(t) == 1:
            ee = gr.add_edge(0, t)
            gr.set_edge_weight(ee, wt)
        gr.remove_edge(e)
        return True
    return False


def compute_maximal_edges(gr):
    """Heaviest interior edge per connected component
    (graph_reviser.cc:125-172)."""
    from ..scallop.ugraph import UGraph
    n = gr.num_vertices() - 1
    ug = UGraph()
    for _ in range(gr.num_vertices()):
        ug.add_vertex()
    ve = []
    for e in gr.edges():
        if e.s == 0 or e.t == n:
            continue
        ug.add_edge(e.s, e.t)
        ve.append((gr.get_edge_weight(e), e.eid, e))
    vv = ug.assign_connected_components()
    ve.sort()
    x = []
    sc = set()
    for w, _, e in reversed(ve):
        if w < 1.5:
            break
        c1 = vv[e.s]
        if c1 in sc:
            continue
        x.append(e)
        sc.add(c1)
    return x


def remove_trivial_vertices(gr):
    """graph_reviser.cc:174-189"""
    flag = False
    n = gr.num_vertices() - 1
    for i in range(1, n):
        if gr.in_degree(i) != 1 or gr.out_degree(i) != 1:
            continue
        if gr.edge(0, i) is None or gr.edge(i, n) is None:
            continue
        gr.clear_vertex(i)
        flag = True
    return flag


def remove_small_exons(gr, min_exon):
    """graph_reviser.cc:191-231"""
    flag = False
    n = gr.num_vertices() - 1
    for i in range(1, n):
        p1 = gr.get_vertex_info(i).lpos
        p2 = gr.get_vertex_info(i).rpos
        if p2 - p1 >= min_exon:
            continue
        if gr.degree(i) <= 0:
            continue
        b = True
        for e in gr.in_edges(i):
            s = e.s
            if s != 0 and gr.get_vertex_info(s).rpos == p1:
                b = False
                break
        if b:
            for e in gr.out_edges(i):
                t = e.t
                if t != n and gr.get_vertex_info(t).lpos == p2:
                    b = False
                    break
        if not b:
            continue
        if gr.edge(0, i) is None and gr.edge(i, n) is None:
            continue
        gr.clear_vertex(i)
        flag = True
    return flag


def remove_small_junctions(gr):
    """graph_reviser.cc:233-312"""
    se = set()
    n = gr.num_vertices() - 1
    for i in range(1, n):
        if gr.degree(i) <= 0:
            continue
        p1 = gr.get_vertex_info(i).lpos
        p2 = gr.get_vertex_info(i).rpos
        wi = gr.get_vertex_weight(i)
        ws = 0.0
        for e in gr.in_edges(i):
            s = e.s
            if s == 0:
                continue
            if gr.get_vertex_info(s).rpos != p1:
                continue
            ws = max(ws, gr.get_vertex_weight(s))
        for e in gr.in_edges(i):
            s = e.s
            w = gr.get_edge_weight(e)
            if s == 0:
                continue
            if gr.get_vertex_info(s).rpos == p1:
                continue
            if ws < 2.0 * w * w + 18.0:
                continue
            if wi < 2.0 * w * w + 18.0:
                continue
            se.add(e)
        wt = 0.0
        for e in gr.out_edges(i):
            t = e.t
            if t == n:
                continue
            if gr.get_vertex_info(t).lpos != p2:
                continue
            wt = max(wt, gr.get_vertex_weight(t))
        for e in gr.out_edges(i):
            t = e.t
            w = gr.get_edge_weight(e)
            if t == n:
                continue
            if gr.get_vertex_info(t).lpos == p2:
                continue
            if ws < 2.0 * w * w + 18.0:
                continue
            if wi < 2.0 * w * w + 18.0:
                continue
            se.add(e)
    if not se:
        return False
    for e in se:
        gr.remove_edge(e)
    return True


def remove_inner_boundaries(gr):
    """graph_reviser.cc:314-347"""
    flag = False
    n = gr.num_vertices() - 1
    for i in range(1, n):
        if gr.in_degree(i) != 1 or gr.out_degree(i) != 1:
            continue
        e1 = gr.in_edges(i)[0]
        e2 = gr.out_edges(i)[0]
        vi = gr.get_vertex_info(i)
        s = e1.s
        t = e2.t
        if s != 0 and t != n:
            continue
        if s != 0 and gr.out_degree(s) == 1:
            continue
        if t != n and gr.in_degree(t) == 1:
            continue
        if vi.stddev >= 0.01:
            continue
        gr.clear_vertex(i)
        flag = True
    return flag


def remove_intron_contamination(gr, ratio):
    """graph_reviser.cc:349-389"""
    flag = False
    n = gr.num_vertices() - 1
    for i in range(1, gr.num_vertices()):
        if gr.in_degree(i) != 1 or gr.out_degree(i) != 1:
            continue
        e1 = gr.in_edges(i)[0]
        e2 = gr.out_edges(i)[0]
        s = e1.s
        t = e2.t
        wv = gr.get_vertex_weight(i)
        vi = gr.get_vertex_info(i)
        if s == 0 or t == n:
            continue
        if gr.get_vertex_info(s).rpos != vi.lpos:
            continue
        if gr.get_vertex_info(t).lpos != vi.rpos:
            continue
        ee = gr.edge(s, t)
        if ee is None:
            continue
        we = gr.get_edge_weight(ee)
        if wv > we or wv > ratio:
            continue
        gr.clear_vertex(i)
        flag = True
    return flag


def keep_surviving_edges(gr, surviving, junctions=None):
    """Keep edges above the surviving weight (or whitelisted junctions),
    pulling in max in/out edges to keep touched vertices connected; drop
    the rest (graph_reviser.cc:391-469 and the junction-set variants
    :471-767)."""
    n = gr.num_vertices() - 1
    sv1 = set()
    sv2 = set()
    se = set()
    for e in gr.edges():
        w = gr.get_edge_weight(e)
        keep = w >= surviving
        if not keep and junctions is not None:
            p = (gr.get_vertex_info(e.s).rpos, gr.get_vertex_info(e.t).lpos)
            keep = p in junctions
        if not keep:
            continue
        se.add(e)
        sv1.add(e.t)
        sv2.add(e.s)
    if junctions is None:
        for ee in compute_maximal_edges(gr):
            se.add(ee)
            sv1.add(ee.t)
            sv2.add(ee.s)
    while True:
        b = False
        for e in sorted(se, key=lambda x: x.eid):
            s, t = e.s, e.t
            if s not in sv1 and s != 0:
                ee = gr.max_in_edge(s)
                # the reference asserts ee exists (graph_reviser.cc:432);
                # on degenerate graphs with edge-less vertices there is
                # nothing to pull in, so just mark the vertex settled
                if ee is not None:
                    se.add(ee)
                    sv2.add(ee.s)
                sv1.add(s)
                b = True
            if t not in sv2 and t != n:
                ee = gr.max_out_edge(t)
                if ee is not None:
                    se.add(ee)
                    sv1.add(ee.t)
                sv2.add(t)
                b = True
            if b:
                break
        if not b:
            break
    ve = [e for e in gr.edges() if e not in se]
    for e in ve:
        gr.remove_edge(e)
    return len(ve) >= 1
