"""Group unbridged fragments into pereads clusters.

Re-implements rnacore/graph_cluster.{h,cc} and pereads_cluster.h: fragments
whose mates align to identical vertex lists are grouped, then recursively
partitioned on each of the four boundary coordinates with a max gap, yielding
clusters with averaged bounds and shared chains.
"""

from __future__ import annotations

from .essential import build_path_from_intron_coordinates
from ..utils.seqs import check_increasing


class PereadsCluster:
    """rnacore/pereads_cluster.h:24-44"""
    __slots__ = ("chain1", "chain2", "bounds", "extend", "frlist", "count",
                 "hits1", "hits2")

    def __init__(self):
        self.chain1 = []
        self.chain2 = []
        self.bounds = [0, 0, 0, 0]
        self.extend = [0, 0, 0, 0]
        self.frlist = []
        self.count = 0
        self.hits1 = []
        self.hits2 = []


def build_pereads_clusters(gr, bd, max_partition_gap, store_hits=False):
    """graph_cluster ctor + build_pereads_clusters (graph_cluster.cc:13-168).

    Runs the native engine (abam_cluster_pereads in native/abam.cpp) when
    available; the Python pipeline below is the fallback and differential
    oracle (byte-parity fuzz-tested)."""
    vc = _build_clusters_native(gr, bd, max_partition_gap, store_hits)
    if vc is not None:
        return vc
    groups, extend = _group_pereads(gr, bd)
    vc = []
    for g, fs in enumerate(groups):
        _build_group_clusters(bd, fs, extend[g], max_partition_gap,
                              store_hits, vc)
    return vc


def _build_clusters_native(gr, bd, max_gap, store_hits):
    """Export the graph/hits/chains as flat arrays and run the C++ engine;
    returns None when the native library is unavailable."""
    try:
        from ..io.bam_native import cluster_pereads_native, native_available
        if not native_available():
            return None
    except Exception:
        return None
    import numpy as np
    cand = []
    bd._frgs_mutated = True    # f[2] writes below (native eligible() flag)
    for i, f in enumerate(bd.frgs):
        if f[2] >= 1 or f[2] <= -1:
            continue
        f[2] = -1          # assume cannot be bridged
        h1, h2 = f[0], f[1]
        hit1, hit2 = bd.hits[h1], bd.hits[h2]
        if hit1.pos > hit2.pos or hit1.rpos > hit2.rpos:
            continue
        cand.append((i, h1, h2))
    n = gr.num_vertices()
    if not cand or n < 3:
        return []
    ni = n - 2
    vstarts = np.fromiter((gr.vinfo[k].lpos for k in range(1, n - 1)),
                          dtype=np.int32, count=ni)
    vends = np.fromiter((gr.vinfo[k].rpos for k in range(1, n - 1)),
                        dtype=np.int32, count=ni)
    adj = np.zeros(max(ni - 1, 1), dtype=np.uint8)
    for k in range(1, n - 2):
        if gr.edge(k, k + 1) is not None:
            adj[k - 1] = 1
    ritems = sorted(gr.rindex.items())
    litems = sorted(gr.lindex.items())
    rkeys = np.asarray([p for p, _ in ritems], dtype=np.int32)
    rvals = np.asarray([v for _, v in ritems], dtype=np.int32)
    lkeys = np.asarray([p for p, _ in litems], dtype=np.int32)
    lvals = np.asarray([v for _, v in litems], dtype=np.int32)
    nh = len(bd.hits)
    sf = getattr(bd, "_scan_fixed", None)
    if sf is not None and sf.shape[0] == nh:
        # scanner-produced bundle: hit coordinates and chains come straight
        # from the flushed arrays (chain of hit j = coords slice at
        # row[17] + 2*row[18], length row[19] — same data hcst stores)
        hpos = np.ascontiguousarray(sf[:, 1])
        hrpos = np.ascontiguousarray(sf[:, 2])
        chain_off = np.ascontiguousarray(sf[:, 17] + 2 * sf[:, 18])
        chain_len = np.ascontiguousarray(sf[:, 19])
        chain_pool = bd._scan_coords
    else:
        hpos = np.fromiter((h.pos for h in bd.hits), dtype=np.int32,
                           count=nh)
        hrpos = np.fromiter((h.rpos for h in bd.hits), dtype=np.int32,
                            count=nh)
        chain_off = np.zeros(nh, dtype=np.int32)
        chain_len = np.zeros(nh, dtype=np.int32)
        pool = []
        for h, p in bd.hcst.hmap.items():
            ch = bd.hcst.chains[p[0]][p[1]][0]
            chain_off[h] = len(pool)
            chain_len[h] = len(ch)
            pool.extend(ch)
        chain_pool = np.asarray(pool if pool else [0], dtype=np.int32)
    cand_frag = np.asarray([c[0] for c in cand], dtype=np.int32)
    cand_h1 = np.asarray([c[1] for c in cand], dtype=np.int32)
    cand_h2 = np.asarray([c[2] for c in cand], dtype=np.int32)
    res = cluster_pereads_native(vstarts, vends, adj, rkeys, rvals,
                                 lkeys, lvals, hpos, hrpos, chain_off,
                                 chain_len, chain_pool, cand_frag,
                                 cand_h1, cand_h2, max_gap)
    if res is None:
        return None
    meta, moff, members, aligned = res
    for j in np.nonzero(aligned)[0].tolist():
        bd.frgs[cand[j][0]][2] = 0      # to be bridged
    vc = []
    nm = len(members)
    mlist = members.tolist()
    for c in range(meta.shape[0]):
        rep, cnt = int(meta[c, 0]), int(meta[c, 1])
        f0 = bd.frgs[rep]
        pc = PereadsCluster()
        pc.count = cnt
        pc.chain1 = bd.hcst.get_chain(f0[0])
        pc.chain2 = bd.hcst.get_chain(f0[1])
        pc.bounds = [int(x) for x in meta[c, 2:6]]
        pc.extend = [int(x) for x in meta[c, 6:10]]
        a = int(moff[c])
        b = int(moff[c + 1]) if c + 1 < meta.shape[0] else nm
        pc.frlist = mlist[a:b]
        if store_hits:
            for fi in pc.frlist:
                f = bd.frgs[fi]
                pc.hits1.append(bd.hits[f[0]])
                pc.hits2.append(bd.hits[f[1]])
        vc.append(pc)
    return vc


def _align_with_bounds(gr, hit, chain, u1, u2):
    """align_hit_to_splice_graph with the endpoint vertices pre-located.

    Returns (first_vertex, last_vertex, key) or None; key identifies the
    vertex path — contiguous ranges collapse to ('r', first, last) so the
    unspliced fast path and a chain that happens to map to a contiguous
    range group together exactly as tuple keys would (graph_cluster.cc:52).
    """
    if u1 < 0 or u2 < 0 or u1 > u2:
        return None
    if not chain:
        if hit.pos > hit.rpos:
            return None
        return (u1, u2, ("r", u1, u2))
    v = [hit.pos] + list(chain) + [hit.rpos]
    if not check_increasing(v):
        return None
    ok, uu = build_path_from_intron_coordinates(gr, v[1:-1])
    if not ok or len(uu) == 0:
        return None
    vv = list(range(u1, uu[0])) + uu + list(range(uu[-1] + 1, u2 + 1))
    if vv == list(range(vv[0], vv[-1] + 1)):
        return (vv[0], vv[-1], ("r", vv[0], vv[-1]))
    return (vv[0], vv[-1], tuple(vv))


def _group_pereads(gr, bd):
    """graph_cluster.cc:28-91, with all four endpoint vertex locations done
    in one batched searchsorted instead of per-hit binary searches."""
    import numpy as np
    findex = {}
    groups = []
    extend = []
    cand = []
    bd._frgs_mutated = True    # f[2] writes below (native eligible() flag)
    for i, f in enumerate(bd.frgs):
        if f[2] >= 1 or f[2] <= -1:
            continue
        f[2] = -1          # assume cannot be bridged
        h1, h2 = f[0], f[1]
        hit1, hit2 = bd.hits[h1], bd.hits[h2]
        assert hit1.hid >= 0 and hit2.hid >= 0
        if hit1.pos > hit2.pos or hit1.rpos > hit2.rpos:
            continue
        cand.append((i, f, h1, h2, hit1, hit2))
    n = gr.num_vertices()
    if not cand or n < 3:
        return groups, extend
    if len(cand) < 32:
        # tiny bundles: per-hit bisect beats numpy call overhead
        uu = [(gr.locate_vertex(hit1.pos), gr.locate_vertex(hit1.rpos - 1),
               gr.locate_vertex(hit2.pos), gr.locate_vertex(hit2.rpos - 1))
              for (_, _, _, _, hit1, hit2) in cand]
    else:
        starts = np.fromiter((gr.vinfo[k].lpos for k in range(1, n - 1)),
                             dtype=np.int64, count=n - 2)
        ends = np.fromiter((gr.vinfo[k].rpos for k in range(1, n - 1)),
                           dtype=np.int64, count=n - 2)
        pts = np.empty((len(cand), 4), dtype=np.int64)
        for j, (_, _, _, _, hit1, hit2) in enumerate(cand):
            pts[j, 0] = hit1.pos
            pts[j, 1] = hit1.rpos - 1
            pts[j, 2] = hit2.pos
            pts[j, 3] = hit2.rpos - 1
        # batched locate_vertex: vertex i covers p iff starts[i-1] <= p < ends[i-1]
        idx = np.searchsorted(starts, pts, side="right")
        i0 = np.maximum(idx - 1, 0)
        ok = (idx > 0) & (pts >= starts[i0]) & (pts < ends[i0])
        uu = np.where(ok, idx, -1).tolist()
    for j, (i, f, h1, h2, hit1, hit2) in enumerate(cand):
        r1 = _align_with_bounds(gr, hit1, bd.hcst.get_chain(h1),
                                int(uu[j][0]), int(uu[j][1]))
        if r1 is None:
            continue
        r2 = _align_with_bounds(gr, hit2, bd.hcst.get_chain(h2),
                                int(uu[j][2]), int(uu[j][3]))
        if r2 is None:
            continue
        f[2] = 0           # to be bridged
        key = (r1[2], r2[2])
        k = findex.get(key)
        # carry the four mate coordinates so the partition stage does not
        # re-read them from the hit objects
        entry = (i, hit1.pos, hit1.rpos, hit2.pos, hit2.rpos)
        if k is None:
            findex[key] = len(groups)
            p1 = gr.get_vertex_info(r1[0]).lpos
            p2 = gr.get_vertex_info(r1[1]).rpos
            p3 = gr.get_vertex_info(r2[0]).lpos
            p4 = gr.get_vertex_info(r2[1]).rpos
            extend.append((p1, p2, p3, p4))
            groups.append([entry])
        else:
            groups[k].append(entry)
    return groups, extend


def _build_group_clusters(bd, fs, ext, max_gap, store_hits, vc):
    """graph_cluster.cc:93-168, with the recursive 4-coordinate partition
    replaced by rank-stable lexsort rounds: each round sorts by (cluster id,
    coordinate r, previous order) and splits at gaps > max_gap, which visits
    clusters in exactly the recursive DFS order."""
    import numpy as np
    n = len(fs)
    if n == 0:
        return
    if n < 48:
        # tiny groups (the common case): numpy per-call overhead dominates,
        # run the recursive reference partition instead (same output; the
        # equivalence is fuzz-tested in tests/test_components.py)
        _build_group_clusters_small(bd, fs, ext, max_gap, store_hits, vc)
        return
    pts = np.asarray([e[1:] for e in fs], dtype=np.int64)
    gid = np.zeros(n, dtype=np.int64)
    rank = np.arange(n, dtype=np.int64)
    perm = rank
    for r in range(4):
        perm = np.lexsort((rank, pts[:, r], gid))
        sg = gid[perm]
        sp = pts[perm, r]
        brk = np.empty(n, dtype=bool)
        brk[0] = True
        brk[1:] = (sg[1:] != sg[:-1]) | (sp[1:] - sp[:-1] > max_gap)
        gid[perm] = np.cumsum(brk) - 1
        rank[perm] = np.arange(n, dtype=np.int64)
    starts = np.nonzero(brk)[0].tolist() + [n]
    fs_arr = np.asarray([e[0] for e in fs], dtype=np.int64)
    for c in range(len(starts) - 1):
        a, b = starts[c], starts[c + 1]
        idx = perm[a:b]
        f0 = bd.frgs[fs[int(idx[0])][0]]
        pc = PereadsCluster()
        pc.count = b - a
        pc.chain1 = bd.hcst.get_chain(f0[0])
        pc.chain2 = bd.hcst.get_chain(f0[1])
        base = pts[idx[0]]
        acc = pts[idx].sum(axis=0) - base * pc.count
        # C-style truncating division (offsets may be negative)
        pc.bounds = [int(v) for v in
                     np.fix(acc / pc.count).astype(np.int64) + base]
        pc.extend = list(ext)
        pc.frlist = fs_arr[idx].tolist()
        if store_hits:
            for k in idx.tolist():
                f = bd.frgs[fs[k][0]]
                pc.hits1.append(bd.hits[f[0]])
                pc.hits2.append(bd.hits[f[1]])
        vc.append(pc)


def _build_group_clusters_small(bd, fs, ext, max_gap, store_hits, vc):
    """graph_cluster.cc:93-168 (recursive partition; small-group path).
    fs entries are (frag_index, p1, r1, p2, r2) from _group_pereads."""
    rows = [[e[1], e[2], e[3], e[4], i] for i, e in enumerate(fs)]
    zz = _partition(rows, 0, max_gap)
    for z in zz:
        if len(z) == 0:
            continue
        e0 = fs[z[0]]
        f0 = bd.frgs[e0[0]]
        pc = PereadsCluster()
        pc.count = 0
        pc.chain1 = bd.hcst.get_chain(f0[0])
        pc.chain2 = bd.hcst.get_chain(f0[1])
        base = e0[1:]
        acc = [0, 0, 0, 0]
        for k in z:
            e = fs[k]
            acc[0] += e[1] - base[0]
            acc[1] += e[2] - base[1]
            acc[2] += e[3] - base[2]
            acc[3] += e[4] - base[3]
            pc.frlist.append(e[0])
            pc.count += 1
            if store_hits:
                f = bd.frgs[e[0]]
                pc.hits1.append(bd.hits[f[0]])
                pc.hits2.append(bd.hits[f[1]])
        if pc.count <= 0:
            continue
        # C-style truncating division (offsets may be negative)
        pc.bounds = [int(acc[i] / pc.count) + base[i] for i in range(4)]
        pc.extend = list(ext)
        vc.append(pc)


def _partition(rows, r, max_gap):
    """Recursive partition on coordinate r (graph_cluster.cc:170-203)."""
    if len(rows) == 0:
        return []
    if r >= 4:
        return [[row[4] for row in rows]]
    rows = sorted(rows, key=lambda x: x[r])
    out = []
    pre = 0
    for k in range(1, len(rows) + 1):
        if k < len(rows) and rows[k][r] - rows[k - 1][r] <= max_gap:
            continue
        out.extend(_partition(rows[pre:k], r + 1, max_gap))
        pre = k
    return out
