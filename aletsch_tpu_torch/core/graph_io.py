"""Splice-graph file I/O and simulation (oracle/fuzz harness support).

Parity with splice_graph::build/write/simulate (rnacore/splice_graph.cc:
329-570): a simple text format for graphs, a region/boundary/junction summary
writer, and a flow-consistent random graph generator used to fuzz the
decomposition.
"""

from __future__ import annotations

import random

from .graph import SpliceGraph, VertexInfo


def write_graph(gr: SpliceGraph, fout):
    """Summary format of splice_graph::write (splice_graph.cc:422-477)."""
    n = gr.num_vertices() - 1
    fout.write("# %s %s %s\n" % (gr.gid, gr.chrm, gr.strand))
    for i in range(1, n):
        vi = gr.get_vertex_info(i)
        if vi.lpos >= vi.rpos:
            continue
        fout.write("region %d %d %.2f\n" % (vi.lpos, vi.rpos,
                                            gr.get_vertex_weight(i)))
    for e in gr.out_edges(0):
        if e.t == n:
            continue
        fout.write("sbound %d %.2f 1\n" % (gr.get_vertex_info(e.t).lpos,
                                           gr.get_edge_weight(e)))
    for e in gr.in_edges(n):
        if e.s == 0:
            continue
        fout.write("tbound %d %.2f 1\n" % (gr.get_vertex_info(e.s).rpos,
                                           gr.get_edge_weight(e)))
    for e in gr.edges():
        if e.s == 0 or e.t == n:
            continue
        p1 = gr.get_vertex_info(e.s).rpos
        p2 = gr.get_vertex_info(e.t).lpos
        if p1 >= p2:
            continue
        fout.write("junction %d %d %.2f 1\n" % (p1, p2, gr.get_edge_weight(e)))


def write_graph_flat(gr: SpliceGraph, fout):
    """Flat vertex/edge list loadable by read_graph_flat
    (splice_graph::build's format, splice_graph.cc:329-376)."""
    n = gr.num_vertices()
    fout.write("%d\n" % n)
    for i in range(n):
        vi = gr.get_vertex_info(i)
        fout.write("v%d %.6f %d\n" % (i, gr.get_vertex_weight(i), vi.length))
    for e in gr.edges():
        fout.write("%d %d %.6f %d\n" % (e.s, e.t, gr.get_edge_weight(e),
                                        gr.get_edge_info(e).length))


def read_graph_flat(fin):
    gr = SpliceGraph()
    n = int(fin.readline())
    for i in range(n):
        parts = fin.readline().split()
        gr.add_vertex()
        gr.set_vertex_weight(i, float(parts[1]))
        vi = VertexInfo()
        vi.length = int(parts[2])
        gr.set_vertex_info(i, vi)
    for line in fin:
        parts = line.split()
        if len(parts) < 4:
            continue
        e = gr.add_edge(int(parts[0]), int(parts[1]))
        gr.set_edge_weight(e, float(parts[2]))
        gr.get_edge_info(e).length = int(parts[3])
    return gr


def read_graph_reference(fin, positions=True):
    """Parse a reference-format ``.graph`` instance exactly like
    splice_graph::build (rnacore/splice_graph.cc:329-376): first line is
    the vertex count, then one ``<name> <weight> <length>`` line per
    vertex, then ``<x> <y> <weight> <length>`` edge lines until EOF.

    The reference build() leaves vertices position-less (pure structural
    mode); with positions=True the vertices are laid out as contiguous
    100 bp blocks (source/sink collapsed to points, like
    splice_graph::simulate, :479-500) so the full decomposition ladder —
    which reads lpos/rpos for boundary grouping and transcript exons —
    can run on reference-era fixtures."""
    if isinstance(fin, str):
        with open(fin) as fh:
            return read_graph_reference(fh, positions)
    gr = read_graph_flat(fin)
    if positions:
        nv = gr.num_vertices()
        for i in range(nv):
            vi = gr.get_vertex_info(i)
            vi.lpos = i * 100
            vi.rpos = i * 100 + 100
            vi.length = 100
            if i == 0:
                vi.rpos = vi.lpos
            if i == nv - 1:
                vi.lpos = vi.rpos
        gr.build_vertex_index()
    return gr


def simulate_graph(nv, ne, mw, seed=0):
    """Random flow-consistent DAG (splice_graph::simulate,
    splice_graph.cc:479-570): add random forward edges, then rewrite edge
    weights as a sum of maximum bottleneck paths so every interior vertex is
    flow-balanced.  Vertex positions are synthesized so the graph behaves
    like a positional splice graph."""
    rng = random.Random(seed)
    gr = SpliceGraph()
    for i in range(nv):
        gr.add_vertex()
    # positions: contiguous 100bp blocks (keeps lindex/rindex sane)
    for i in range(nv):
        vi = VertexInfo(lpos=i * 100, rpos=i * 100 + 100, length=100)
        if i == 0:
            vi.rpos = vi.lpos
        if i == nv - 1:
            vi.lpos = vi.rpos
        gr.set_vertex_info(i, vi)
    tries = 0
    while gr.num_edges() < ne and tries < 50 * ne:
        tries += 1
        s = rng.randrange(nv)
        if s == nv - 1:
            continue
        t = rng.randrange((nv - s - 1) // 2 + 1) + s + 1
        if s == 0 and t == nv - 1:
            continue
        if gr.edge(s, t) is not None:
            continue
        f = rng.randrange(mw - 10) + 10
        e = gr.add_edge(s, t)
        gr.set_edge_weight(e, float(f))
    # rewrite weights as sum of bottleneck path extractions
    med = {}
    while True:
        w, path = gr.compute_maximum_path_w()
        if w <= 0 or not path:
            break
        w = float(int(w))
        if w <= 0:
            break
        for e in path:
            gr.set_edge_weight(e, gr.get_edge_weight(e) - w)
            med[e] = med.get(e, 0.0) + w
    for e in gr.edges():
        if e not in med:
            gr.remove_edge(e)
    for e, w in med.items():
        gr.set_edge_weight(e, w)
    # vertex weights = in-flow
    for i in range(nv):
        wx = sum(gr.get_edge_weight(e) for e in gr.in_edges(i))
        wy = sum(gr.get_edge_weight(e) for e in gr.out_edges(i))
        gr.set_vertex_weight(i, wy if i == 0 else wx)
    gr.build_vertex_index()
    return gr
