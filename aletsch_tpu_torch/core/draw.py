"""TikZ rendering of splice graphs for visual debugging.

Parity with graph/draw.{h,cc} and splice_graph::draw
(rnacore/splice_graph.cc:1227-1253): vertices in a row with weight/interval
labels, curved weighted edges.
"""

from __future__ import annotations

HEADER = r"""\documentclass{standalone}
\usepackage{tikz}
\begin{document}
\begin{tikzpicture}[mycircle/.style={draw, circle, minimum size=8mm, inner sep=1pt}]
"""

FOOTER = "\\end{tikzpicture}\n\\end{document}\n"


def draw_splice_graph(gr, path, length=1.5, order=None):
    """Write a standalone TikZ document rendering gr."""
    n = gr.num_vertices()
    order = order or list(range(n))
    pos = {v: i for i, v in enumerate(order)}
    with open(path, "w") as f:
        f.write(HEADER)
        for i in range(n):
            vi = gr.get_vertex_info(i)
            w = gr.get_vertex_weight(i)
            ll = vi.lpos % 100000
            rr = vi.rpos % 100000
            label = "%d:%.1f:%d-%d" % (i, w, ll, rr)
            f.write("\\node[mycircle] (v%d) at (%.2f, 0) "
                    "{\\tiny %s};\n" % (i, pos[i] * length, label))
        for e in gr.edges():
            w = gr.get_edge_weight(e)
            strand = gr.get_edge_info(e).strand
            bend = 30 if (e.t - e.s) > 1 else 0
            f.write("\\draw[->, bend left=%d] (v%d) to "
                    "node[above] {\\tiny %.1f:%d} (v%d);\n"
                    % (bend, e.s, w, strand, e.t))
        f.write(FOOTER)
