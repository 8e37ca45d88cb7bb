"""Extract REAL region-wave tensors for the sharded mesh step.

parallel/mesh.py expresses one bulk-synchronous assembly wave as a padded
tensor batch (adjacency bottleneck DP, coverage-segment stats, splice
incidence for the similarity matmul, per-sample junction support reduced
over the mesh 'sample' axis).  This module fills that batch from the real
pipeline objects of a cohort run — the same draft splice graphs the
bridger builds (meta/bundle.py bridge -> core/graph_builder.py, mirroring
bundle.cc/graph_builder.cc), the bundles' CoverageMaps, their splice sets
(meta/bundle_group.cc:190-231 operands), and the per-sample junction
weights that feed junction_support (meta/assembler.cc:198-283) — so the
multichip dryrun and the mesh tests validate the sharded step on real
data instead of random tensors (numpy oracle: `host_oracle`).

Batch row = one bundle group of a region wave; every padded vocabulary
(junctions J, splice positions P, samples Ns, vertices V, segments S)
records what it dropped in `dropped` — no silent truncation.
"""

from __future__ import annotations

import numpy as np


class _BundleView:
    """GraphBuilder-facing view of a bundle.  Light bundles (no Hit
    objects, core/bundle.py materialize_bundle light=True) carry their
    splice chains only in the scanner arrays; this rebuilds the hit
    ChainSet from them exactly like the full materialization
    (core/bundle.py:78-83) without mutating the pipeline's bundle."""

    def __init__(self, bd):
        from ..core.chain_set import ChainSet
        self.chrm = bd.chrm
        self.lpos = bd.lpos
        self.rpos = bd.rpos
        self.strand = bd.strand
        self.mmap = bd.mmap
        self.fcst = bd.fcst
        self.hcst = bd.hcst
        if getattr(bd, "_light", False):
            cst = ChainSet()
            sf = bd._scan_fixed
            coords = bd._scan_coords
            for j in range(sf.shape[0]):
                sc = int(sf[j, 19])
                if sc:
                    off = int(sf[j, 17]) + 2 * int(sf[j, 18])
                    cst.add(coords[off:off + sc].tolist(), j,
                            chr(int(sf[j, 12])))
            self.hcst = cst


def _build_draft_graph(bd):
    from ..core.graph import SpliceGraph
    from ..core.graph_builder import GraphBuilder
    gr = SpliceGraph()
    GraphBuilder(_BundleView(bd), bd.cfg).build(gr)
    return gr


def _group_row(gv, V, S, P_, Ns, J, jvocab, svocab, pvocab, dropped):
    """Extract one group's tensors; returns the per-group row dict."""
    lead = gv[0]
    gr = _build_draft_graph(lead)
    n = gr.num_vertices()
    W = np.zeros((V, V), dtype=np.float32)
    for e in gr.edges():
        if e.s >= V or e.t >= V:
            dropped["vertices"] += 1
            continue
        W[e.s, e.t] = np.float32(gr.get_edge_weight(e))
    if n > V:
        dropped["graphs_truncated"] += 1

    l, r, v = lead.mmap.segments
    ns = len(l)
    seg_vals = np.zeros(S, dtype=np.float32)
    seg_lens = np.zeros(S, dtype=np.float32)
    seg_mask = np.zeros(S, dtype=np.float32)
    m = min(ns, S)
    if ns > S:
        dropped["segments"] += ns - S
    seg_vals[:m] = np.asarray(v[:m], dtype=np.float32)
    seg_lens[:m] = (np.asarray(r[:m], dtype=np.float64)
                    - np.asarray(l[:m], dtype=np.float64)).astype(np.float32)
    seg_mask[:m] = 1.0
    span = np.float32((seg_lens[:m]).sum(dtype=np.float64))

    inc = np.zeros(P_, dtype=np.float32)
    for p in lead.splices:
        c = pvocab.get(p)
        if c is None:
            if len(pvocab) >= P_:
                dropped["splices"] += 1
                continue
            c = pvocab[p] = len(pvocab)
        inc[c] = 1.0

    # per-sample junction weights: assignment semantics per (junction,
    # sample), like collect_support's sup2abd[p][sid] = e->wrt
    jsup = np.zeros((Ns, J), dtype=np.float32)
    for bd in gv:
        sid = bd.sp.sample_id
        srow = svocab.get(sid)
        if srow is None:
            if len(svocab) >= Ns:
                dropped["samples"] += 1
                continue
            srow = svocab[sid] = len(svocab)
        g1 = gr if bd is lead else _build_draft_graph(bd)
        nv = g1.num_vertices()
        for e in g1.edges():
            if e.s == 0 or e.t == nv - 1:
                continue
            p0 = g1.get_vertex_info(e.s).rpos
            p1 = g1.get_vertex_info(e.t).lpos
            if p0 == p1:
                continue
            jx = jvocab.get((p0, p1))
            if jx is None:
                if len(jvocab) >= J:
                    dropped["junctions"] += 1
                    continue
                jx = jvocab[(p0, p1)] = len(jvocab)
            jsup[srow, jx] = np.float32(g1.get_edge_weight(e))
    return dict(W=W, seg_vals=seg_vals, seg_lens=seg_lens,
                seg_mask=seg_mask, span=span, inc=inc, jsup=jsup)


def capture_cohort_tensors(params, B=8, V=32, S=16, P_=64, Ns=2, J=16):
    """Run the cohort pipeline (meta/incubator.py), snapshotting the first
    B groups' tensors at assembly time.  Returns (tensors, info):
    tensors = (W, seg_vals, seg_lens, seg_mask, span, inc, jsup) with the
    mesh-step shapes ([B,V,V], [B,S]x3, [B], [B,P_], [Ns,B,J]); info has
    the group count captured and the `dropped` audit."""
    from ..meta.incubator import Incubator

    rows = []
    jvocab, svocab, pvocab = {}, {}, {}
    dropped = {"vertices": 0, "graphs_truncated": 0, "segments": 0,
               "splices": 0, "samples": 0, "junctions": 0}

    inc_ = Incubator(params)
    orig = inc_._assemble_groups

    def hook(asms, gvs):
        for gv in gvs:
            if len(rows) < B and len(gv) >= 1:
                rows.append(_group_row(gv, V, S, P_, Ns, J,
                                       jvocab, svocab, pvocab, dropped))
        return orig(asms, gvs)

    inc_._assemble_groups = hook
    inc_.resolve()

    ng = len(rows)
    W = np.zeros((B, V, V), dtype=np.float32)
    seg_vals = np.zeros((B, S), dtype=np.float32)
    seg_lens = np.zeros((B, S), dtype=np.float32)
    seg_mask = np.zeros((B, S), dtype=np.float32)
    span = np.ones(B, dtype=np.float32)
    inc = np.zeros((B, P_), dtype=np.float32)
    jsup = np.zeros((Ns, B, J), dtype=np.float32)
    for b, row in enumerate(rows):
        W[b] = row["W"]
        seg_vals[b] = row["seg_vals"]
        seg_lens[b] = row["seg_lens"]
        seg_mask[b] = row["seg_mask"]
        span[b] = max(row["span"], 1.0)
        inc[b] = row["inc"]
        jsup[:, b, :] = row["jsup"]
    info = dict(groups=ng, dropped=dropped, samples=len(svocab),
                junctions=len(jvocab), splices=len(pvocab))
    return (W, seg_vals, seg_lens, seg_mask, span, inc, jsup), info


def host_oracle(W, seg_vals, seg_lens, seg_mask, span, inc, jsup):
    """Numpy reference for parallel/mesh.py's step on the same tensors.
    bottleneck / mx / sim / support are exact (min-max semiring, integral
    counts, order-free 2-sample sums); ave/dev are float-reduction order
    sensitive, compare with allclose."""
    from ..ops.bridge_dp import NEG, POS

    W = np.asarray(W, dtype=np.float32)
    B, V, _ = W.shape
    Wm = np.where(W > 0, W, np.float32(NEG))
    T = np.full((B, V, V), np.float32(NEG), dtype=np.float32)
    for i in range(V):
        T[:, i, i] = np.float32(POS)
    for v in range(1, V):
        cand = np.minimum(T, Wm[:, :, v][:, None, :])
        best = cand.max(axis=2)
        T[:, :, v] = np.maximum(T[:, :, v], best)
    bottleneck = T[:, 0, V - 1]

    vm = seg_vals * seg_mask
    lm = seg_lens * seg_mask
    ave = (vm * lm).sum(axis=1) / np.maximum(span, 1.0)
    var = (lm * (seg_vals - ave[:, None]) ** 2 * seg_mask).sum(axis=1)
    dev = np.sqrt(var / np.maximum(span, 1.0))
    mx = vm.max(axis=1)

    sim = inc @ inc.T
    support = jsup.sum(axis=0)
    return bottleneck, ave, dev, mx, sim, support
