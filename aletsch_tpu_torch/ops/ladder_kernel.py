"""Batched device form of the scallop resolution-ladder prefix.

Counterpart of aletsch_tpu/ops/ladder_kernel.py, section by section and
name by name, as plain PyTorch on tensors, and the wrapper of its
hand-written CUDA kernel.  The device form of
ops/ladder_ref.py (which is itself the dense spec of scallop/scallop.cc:
47-150 rungs 1-4: resolve_broken_vertex, resolve_trivial_vertex_fast,
resolve_trivial_vertex(1, fast), resolve_smallest_edges).  A whole wave of
graphs runs in lockstep inside one Python `while` loop; each iteration
advances every active graph by ONE event (a single arm fire, one pair of
a trivial-vertex decomposition, or an arm transition) with the scan
portions window-vectorized:

    host semantics: scan vertices ascending, re-evaluating under the
    state mutated by earlier fires in the same pass.  Between two fires
    the state is static, so the whole window [cursor, next-fire) is
    evaluated in one shot; prefix-min masks reproduce the sequential
    best-tracking including its tie rules (later candidate wins on
    equal ratio) and the early-break (ratio < jump_ratio).

All arithmetic is f64 and transcribed operation for operation from the
host (ordered adjacency-list sums via per-vertex list matrices, sqrt
balancing, split/merge weight flow, last-min-wins smallest-edge scans).
Eager PyTorch runs every operation as its own kernel, so nothing contracts
into a fused multiply-add and each sum along a list runs in list order: on
an IEEE-f64 device the emitted decision log is bit-identical to the host
ladder, the trust-mode contract shared with the fused drain
(ops/greedy_fused.py).  This function must not be compiled or fused.

_build gives the three parts of the reference's function: init (the
loop's initial state), body (one iteration) and finish (the results).
ladder_plain() drives them with each operation launched as it comes and
fetches `pc` to the host once an iteration: the loop condition and the two
guards of the expensive tables (dominates, extends) are read from that one
copy.  Every update is functional, as in the reference: a tensor that is
read after its update is kept beside its new value.  ladder_cuda()
launches the hand-written kernel csrc/ladder.cu, which runs each graph's
whole loop on the card in one launch with the same results; ladder()
takes the kernel for CUDA tensors and the plain loop for CPU tensors.

Status codes per graph: 0 = CLEAN (arms exhausted; the host resumes at
the router rungs), 1 = OVERFLOW (edge-slot / pair / decision-log / list
capacity hit; the host ignores the log and redoes the whole ladder); a
graph still running at the iteration cap reads out as OVERFLOW.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np
import torch

from . import ladder_ref
from .constants import LADDER_B
from .ladder_ref import BROKEN, SMALLEST, TRIVIAL  # noqa: F401 (re-export)

DEFAULT_B = LADDER_B
DEFAULT_V = 64
DEFAULT_E = 256
DEFAULT_H = 64
DEFAULT_L = 32
DEFAULT_DMAX = 32
DEFAULT_DLOG = 192

# pc values
PC_BROKEN = 0
PC_FAST = 1
PC_TV1 = 2
PC_SMALL = 3
PC_DECOMP = 4
PC_DONE = 5

ST_RUN = -1
ST_CLEAN = 0
ST_OVERFLOW = 1

INF = np.float64(1e300)
BIGI = np.int32(2 ** 30)

# argument order of ladder(), and of the arrays pack_states returns
ARG_NAMES = ("esrc", "edst", "ewrt", "estr", "esin", "esout", "ealive",
             "nedges", "nstamp", "nz", "hedge", "hlen", "nv", "jump",
             "smallr", "guard", "smin")


# the loop's carried state, in the order init() returns it and body() takes
# and returns it
STATE_NAMES = ("esrc", "edst", "ewrt", "estr", "esin", "esout", "ealive",
               "nedges", "nstamp", "nz", "hedge", "hlen", "pc", "cur",
               "fired", "tvr", "tvroot", "smr", "sme", "droot", "dp_e1",
               "dp_e2", "dp_w", "dp_n", "dp_k", "dp_ms", "dside", "dret",
               "dretc", "larm", "ltgt", "ndec", "status")
PC_SLOT = STATE_NAMES.index("pc")


def ieee_sqrt(x):
    """f64 sqrt, correctly rounded on any device.  torch's CPU kernel is
    not: its vectorised f64 sqrt misses by an ulp on about 1 % of inputs
    (sqrt(0.5) among them) on an AVX-512 host, so on the CPU numpy's
    hardware sqrt takes its place.  CUDA's f64 sqrt is IEEE."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _build(B, V, E, H, L, DMAX, DLOG, dev):
    """(init, body, finish) of the ladder for one batch shape on one
    device: init(*the 17 inputs) -> (state, params), the loop's carried
    state (STATE_NAMES) and the per-graph parameters the loop only reads
    (nv, jump, smallr, guard, smin); body(state, params, any_tv1,
    any_small) -> the state one event later; finish(state) -> ladder()'s
    results."""
    # Integer state is int64 inside: gather, scatter and index take int64
    # indices only, and nearly every integer tensor here indexes another,
    # so i32 state would be widened some two hundred times an iteration.
    # The values are the reference's (all far below 2^31); the results go
    # back as i32.
    ix, f64 = torch.int64, torch.float64
    INFf = float(INF)
    BIGi = int(BIGI)
    bi = torch.arange(B, device=dev)
    varange = torch.arange(V, dtype=ix, device=dev)
    earange = torch.arange(E, dtype=ix, device=dev)
    lpos = torch.arange(L, dtype=ix, device=dev)

    # ------------------------------------------------ indexing primitives

    consts = {}

    def const(v, dtype):
        """Cached 0-dim tensor of a Python scalar on the device."""
        key = (type(v), v, dtype)
        if key not in consts:
            consts[key] = torch.full((), v, dtype=dtype, device=dev)
        return consts[key]

    def where(cond, a, b):
        """torch.where; a Python scalar operand becomes a cached 0-dim
        device tensor of the other operand's type (ix, f64 or bool when
        both are scalars), because torch.where itself would fill a new
        device tensor with it at every call."""
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not (ta and tb):
            kind = a.dtype if ta else b.dtype if tb else \
                torch.bool if isinstance(a, bool) else \
                ix if isinstance(a, int) else f64
            a = a if ta else const(a, kind)
            b = b if tb else const(b, kind)
        return torch.where(cond, a, b)

    def rowget(x, idx):
        """x[b, idx[b, ...]]: per-row gather along axis 1 of x [B, N]."""
        return torch.gather(x, 1, idx.reshape(B, -1).long()).reshape(
            idx.shape)

    def rowset(x, idx, mask, v):
        """x.at[b, idx[b]].set(where(mask, v, x[b, idx[b]])) as a new
        tensor; x itself stays as it was."""
        ix = idx.long()[:, None]
        cur = torch.gather(x, 1, ix)[:, 0]
        new = where(mask, v, cur).to(x.dtype)
        return torch.scatter(x, 1, ix, new[:, None])

    def rowset_drop(x, idx, v):
        """x.at[b, idx[b, j]].set(v[b, j]) with entries at idx == N
        dropped (x is [B, N]): scatter into one more column, then slice it
        off.  Kept entries of a row never share a slot."""
        wide = torch.cat([x, torch.zeros((B, 1), dtype=x.dtype, device=dev)],
                         dim=1)
        wide.scatter_(1, idx.long(), v)
        return wide[:, :x.shape[1]].contiguous()

    def first_true(mask, none):
        """Index of the first true along axis 1 of mask [B, N], or `none`
        where a row has no true."""
        n = mask.shape[1]
        pos = torch.arange(n, dtype=ix, device=dev)
        f = where(mask, pos, n).amin(dim=1)
        return where(f < n, f, none).to(ix)

    def last_true(mask):
        """Index of the last true along the last axis, or N - 1 where
        there is none (N - 1 - argmax of the reversed mask)."""
        n = mask.shape[-1]
        pos = torch.arange(n, dtype=ix, device=dev)
        f = where(mask, pos, -1).amax(dim=-1)
        return where(f >= 0, f, n - 1).to(ix)

    def ordered_sum(w):
        """Sum of w [..., N] along its last axis in index order, one add
        after another (the host's list order)."""
        acc = torch.zeros(w.shape[:-1], dtype=f64, device=dev)
        for j in range(w.shape[-1]):
            acc = acc + w[..., j]
        return acc

    def seg_tables(esrc, edst, ewrt, esin, esout, ealive, nz, estr, nv):
        """Per-iteration vectorized tables.

        Returns dict with:
          din/dout [B,V] degrees; lin/lout [B,V,DMAX] adjacency-list
          matrices (edge ids in stamp order, -1 pad); inw/outw [B,V]
          ordered f64 sums; strand degree tables; smallest-edge scans;
          deg_over [B] (some list exceeded DMAX).
        """
        alive = ealive
        # one-hot [B,E,V] membership (E*V bools)
        in_m = alive[:, :, None] & (edst[:, :, None] == varange[None, None])
        out_m = alive[:, :, None] & (esrc[:, :, None] == varange[None, None])
        din = torch.sum(in_m, dim=1, dtype=ix)
        dout = torch.sum(out_m, dim=1, dtype=ix)
        deg_over = torch.any(torch.maximum(din, dout) > DMAX, dim=1)

        # rank of each edge within its (dst, in-stamp) list
        same_in = alive[:, :, None] & alive[:, None, :] \
            & (edst[:, :, None] == edst[:, None, :]) \
            & (esin[:, None, :] < esin[:, :, None])
        rank_in = torch.sum(same_in, dim=2, dtype=ix)
        same_out = alive[:, :, None] & alive[:, None, :] \
            & (esrc[:, :, None] == esrc[:, None, :]) \
            & (esout[:, None, :] < esout[:, :, None])
        rank_out = torch.sum(same_out, dim=2, dtype=ix)

        ri = torch.clamp(rank_in, max=DMAX - 1)
        ro = torch.clamp(rank_out, max=DMAX - 1)
        src_c = torch.clamp(esrc, 0, V - 1)
        dst_c = torch.clamp(edst, 0, V - 1)
        # dead edges scatter to the dropped out-of-range row B so they can
        # never clobber a live slot; two edges meet in one slot only past
        # DMAX (deg_over), where the larger edge id stays
        row = where(alive, bi[:, None], B)
        eid2 = earange[None, :].expand(B, E)

        def lists(v_c, rank):
            flat = ((row * V + v_c) * DMAX + rank).reshape(-1)
            out = torch.full(((B + 1) * V * DMAX,), -1, dtype=ix,
                             device=dev)
            out.scatter_reduce_(0, flat, eid2.reshape(-1), "amax",
                                include_self=True)
            return out[:B * V * DMAX].reshape(B, V, DMAX)

        lin = lists(dst_c, ri)
        lout = lists(src_c, ro)

        def wsum(lst):
            """Ordered f64 sum along the DMAX list axis."""
            ok = lst >= 0
            w = rowget(ewrt, torch.clamp(lst, 0, E - 1))
            return ordered_sum(where(ok, w, 0.0))

        inw = wsum(lin)
        outw = wsum(lout)

        def smallest(lst):
            """Host compute_smallest_{in,out}_edge per vertex: the
            last-min-wins scan (scallop.cc:2967-3007).  A scan that takes
            each entry with w <= the running minimum ends on the last
            entry that attains the list's minimum."""
            ok = lst >= 0
            w = where(ok, rowget(ewrt, torch.clamp(lst, 0, E - 1)),
                            INFf)
            minw = torch.amin(w, dim=2)
            hit = ok & (w <= minw[:, :, None])
            j = last_true(hit)
            e = torch.gather(lst, 2, j.long()[:, :, None])[:, :, 0]
            return where(torch.any(hit, dim=2), e, -1), minw

        sm_in_e, sm_in_w = smallest(lin)
        sm_out_e, sm_out_w = smallest(lout)

        # strand degree tables [B,V,3] per side
        def strdeg(m):
            out = []
            for z in range(3):
                out.append(torch.sum(m & (estr[:, :, None] == z), dim=1))
            return torch.stack(out, dim=-1).to(ix)
        sin = strdeg(in_m)
        sout = strdeg(out_m)
        mixed = ((sin[:, :, 1] + sout[:, :, 1]) >= 1) \
            & ((sin[:, :, 2] + sout[:, :, 2]) >= 1)

        interior = (varange[None, :] >= 1) & (varange[None, :]
                                              < nv[:, None] - 1)
        return dict(din=din, dout=dout, lin=lin, lout=lout, inw=inw,
                    outw=outw, sm_in_e=sm_in_e, sm_in_w=sm_in_w,
                    sm_out_e=sm_out_e, sm_out_w=sm_out_w, sin=sin,
                    sout=sout, mixed=mixed, interior=interior,
                    deg_over=deg_over)

    # ---------------------------------------------------- hyper primitives

    def h_valid(hlen):
        return lpos[None, None, :] < hlen[:, :, None]          # [B,H,L]

    def shift_left(x, n, fill):
        """x [B,H,L] moved n slots towards index 0, `fill` behind."""
        pad = torch.full((B, H, n), fill, dtype=x.dtype, device=dev)
        return torch.cat([x[:, :, n:], pad], dim=2)

    def shift_right(x, fill):
        pad = torch.full((B, H, 1), fill, dtype=x.dtype, device=dev)
        return torch.cat([pad, x[:, :, :-1]], dim=2)

    def hs_remove_mask(hedge, hlen, emask):
        """Remove every edge in emask [B,E]: occurrences -> -1."""
        idx = torch.clamp(hedge, 0, E - 1)
        hit = rowget(emask, idx) & (hedge >= 0) & h_valid(hlen)
        return where(hit, -1, hedge)

    def hs_replace_single(hedge, hlen, x, e):
        """replace_list([x], e): all occurrences of x -> e."""
        hit = (hedge == x[:, None, None]) & h_valid(hlen)
        return where(hit, e[:, None, None], hedge)

    def hs_replace_pair(hedge, hlen, x, y, e):
        """replace_list([x,y], e): consecutive [x,y] -> [e] (shrinks)."""
        vmask = h_valid(hlen)
        nxt = shift_left(hedge, 1, -1)
        nvalid = shift_left(vmask, 1, False)
        match = vmask & nvalid & (hedge == x[:, None, None]) \
            & (nxt == y[:, None, None])
        he = where(match, e[:, None, None], hedge)
        # delete the slot after each match
        del_m = shift_right(match, False) & vmask
        keep = vmask & ~del_m
        key = where(keep, lpos[None, None, :], BIGi)
        order = torch.argsort(key, dim=2, stable=True)
        gathered = torch.gather(he, 2, order)
        nkeep = torch.sum(keep, dim=2, dtype=ix)
        he2 = where(lpos[None, None, :] < nkeep[:, :, None],
                          gathered, -1)
        return he2, nkeep

    def pair_code(a, b):
        return (a + 2) * (E + 2) + (b + 2)

    def dominates(hedge, hlen, ec, right):
        """left/right_dominate for candidate edges ec [B,C] (C=V).
        hyper_set.cc:1003-1082; right=True mirrors the scan direction."""
        C = ec.shape[1]
        vmask = h_valid(hlen)                                   # [B,H,L]
        if right:
            hedge = torch.flip(hedge, [2])
            vmask = torch.flip(vmask, [2])
            # valid slots are now right-aligned; shift them left-aligned
            # by sorting valid-first while preserving order
            key = where(vmask, lpos[None, None, :], BIGi)
            order = torch.argsort(key, dim=2, stable=True)
            hedge = torch.gather(hedge, 2, order)
            ln = torch.sum(vmask, dim=2, dtype=ix)
            vmask = lpos[None, None, :] < ln[:, :, None]
        occ = vmask[:, None] & (hedge[:, None] == ec[:, :, None, None])
        nxt1 = shift_left(hedge, 1, -1)
        nv1 = shift_left(vmask, 1, False)
        nxt2 = shift_left(hedge, 2, -1)
        nv2 = shift_left(vmask, 2, False)
        prv = shift_right(hedge, -1)
        pv = shift_right(vmask, False)
        has_next = occ & nv1[:, None] & (nxt1[:, None] != -1)
        is_start = ~pv[:, None] | (prv[:, None] == -1)
        n1 = nxt1[:, None].expand(has_next.shape)
        n2 = where(nv2[:, None].expand(has_next.shape),
                         nxt2[:, None].expand(has_next.shape), -1)
        x1m = has_next & is_start
        x2m = has_next & ~is_start
        SENT = (E + 2) * (E + 2) + 7
        c_x1 = where(x1m, pair_code(n1, n2), SENT)
        c_x2a = where(x2m, pair_code(n1, -1), SENT)
        c_x2b = where(x2m, pair_code(n1, n2), SENT)
        c_x1 = c_x1.reshape(B, C, H * L)
        c_x2 = torch.cat([c_x2a.reshape(B, C, H * L),
                          c_x2b.reshape(B, C, H * L)], dim=2)
        x2s = torch.sort(c_x2, dim=2).values
        posn = torch.searchsorted(
            x2s.reshape(B * C, 2 * H * L),
            c_x1.reshape(B * C, H * L).contiguous()).reshape(B, C, H * L)
        found = torch.gather(
            x2s, 2, torch.clamp(posn, 0, 2 * H * L - 1)) == c_x1
        ok = torch.all((c_x1 == SENT) | found, dim=2)           # x1 <= x2
        return ok

    def extends(hedge, hlen, ec):
        """(left_extend, right_extend) for candidate edges ec [B,C]."""
        vmask = h_valid(hlen)
        occ = vmask[:, None] & (hedge[:, None] == ec[:, :, None, None])
        prv = shift_right(hedge, -1)
        pv = shift_right(vmask, False)
        nxt = shift_left(hedge, 1, -1)
        nvv = shift_left(vmask, 1, False)
        le = torch.any((occ & pv[:, None] & (prv[:, None] != -1))
                       .flatten(2), dim=2)
        re = torch.any((occ & nvv[:, None] & (nxt[:, None] != -1))
                       .flatten(2), dim=2)
        return le, re

    # -------------------------------------------------------------- kernel

    def init(esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp,
             nz, hedge, hlen, nv, jump, smallr, guard, smin):
        esrc, edst, estr, esin, esout, nedges, nstamp, hedge, hlen, nv = (
            t.to(ix) for t in (esrc, edst, estr, esin, esout, nedges, nstamp,
                               hedge, hlen, nv))

        def full(shape, fill, dtype=ix):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        state = (
            esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp,
            nz, hedge, hlen,
            where(nv > 0, PC_BROKEN, PC_DONE),       # pc
            full((B,), 1),                           # cur
            full((B,), False, torch.bool),           # fired (pass flag)
            full((B,), INFf, f64),                   # tv best ratio
            full((B,), -1),                          # tv best root
            smallr.to(f64),                          # sm best ratio
            full((B,), -1),                          # sm best edge
            full((B,), -1),                          # droot
            full((B, DMAX), -1),                     # dp_e1 (sorted order)
            full((B, DMAX), -1),                     # dp_e2
            full((B, DMAX), 0.0, f64),               # dp_w
            full((B,), 0),                           # dp_n
            full((B,), 0),                           # dp_k
            full((B,), 0),                           # dp_m_single (npairs)
            full((B,), 0),                           # dside (0: e1 single)
            full((B,), 0),                           # dret pc
            full((B,), 1),                           # dret cur
            full((B, DLOG), 0),                      # log arm
            full((B, DLOG), 0),                      # log tgt
            full((B,), 0),                           # ndec
            where(nv > 0, ST_RUN, ST_CLEAN),         # status
        )
        return state, (nv, jump, smallr, guard, smin)

    def logd(larm, ltgt, ndec, mask, arm, tgt):
        """Append a decision for masked graphs."""
        slot = torch.clamp(ndec, 0, DLOG - 1)
        la = rowset(larm, slot, mask, arm)
        lt = rowset(ltgt, slot, mask, tgt)
        nd = ndec + mask.to(ix)
        over = mask & (nd > DLOG)
        return la, lt, nd, over

    def body(state, params, any_tv1, any_small):
        (esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp,
         nz, hedge, hlen, pc, cur, fired, tvr, tvroot, smr, sme,
         droot, dp_e1, dp_e2, dp_w, dp_n, dp_k, dp_ms, dside,
         dret, dretc, larm, ltgt, ndec, status) = state
        nv, jump, smallr, guard, smin = params

        t = seg_tables(esrc, edst, ewrt, esin, esout, ealive, nz, estr, nv)
        din, dout = t["din"], t["dout"]
        active_v = t["interior"] & nz
        # arm masks snapshot pc at iteration start: a transition takes
        # effect NEXT iteration, so the heavy-table gating (dominates /
        # extends on the start-pc) can never starve a scan that chained
        # in mid-body
        pc0 = pc

        # ---------------- common candidate predicates (current state)
        # balance ratio per vertex (host compute_balance_ratio)
        w1, w2 = t["inw"], t["outw"]
        bal_r = where(w1 >= w2,
                            w1 / where(w2 == 0.0, 1.0, w2),
                            w2 / where(w1 == 0.0, 1.0, w1))
        head_in = t["lin"][:, :, 0]
        head_out = t["lout"][:, :, 0]
        hi_c = torch.clamp(head_in, 0, E - 1)
        ho_c = torch.clamp(head_out, 0, E - 1)
        src_of_hi = rowget(esrc, hi_c)
        dst_of_ho = rowget(edst, ho_c)
        outdeg_src = rowget(dout, torch.clamp(src_of_hi, 0, V - 1))
        indeg_dst = rowget(din, torch.clamp(dst_of_ho, 0, V - 1))
        d1_is1 = din == 1
        d2_is1 = dout == 1
        cls1_nofast = (d1_is1 & (outdeg_src == 1)) \
            | (d2_is1 & (indeg_dst == 1))
        # dominate queries are the body's most expensive tables; only
        # TV1-scanning graphs read them, so skip the whole computation
        # on iterations where no graph is in that arm (any_tv1, read from
        # pc on the host before this iteration)
        if any_tv1:
            rdom = dominates(hedge, hlen, hi_c, right=True)
            ldom = dominates(hedge, hlen, ho_c, right=False)
        else:
            rdom = torch.zeros((B, V), dtype=torch.bool, device=dev)
            ldom = rdom
        cls1_fast = cls1_nofast | (d1_is1 & rdom) | (d2_is1 & ldom)
        one_sided = (d1_is1 | d2_is1) & (din > 0) & (dout > 0)
        base_triv = active_v & (din > 0) & (dout > 0) \
            & ~((din >= 2) & (dout >= 2)) & ~t["mixed"] & one_sided

        pos_ge_cur = varange[None, :] >= cur[:, None]

        # ======================= PC_BROKEN =======================
        brk_cand = active_v & ((din == 0) | (dout == 0))
        brk_any = torch.any(brk_cand, dim=1)
        brk_x = first_true(brk_cand, 0)
        m_br = (pc0 == PC_BROKEN)
        fire_br = m_br & brk_any
        # apply: kill edges at x, hs-remove them
        exm = (edst == brk_x[:, None]) | (esrc == brk_x[:, None])
        exm = exm & ealive & fire_br[:, None]
        ealive_b = ealive & ~exm
        hedge_b = hs_remove_mask(hedge, hlen, exm)
        nz_b = rowset(nz, brk_x, fire_br, False)
        larm, ltgt, ndec, ovf_b = logd(larm, ltgt, ndec, fire_br,
                                       BROKEN, brk_x)
        # no candidate: move to FAST
        to_fast = m_br & ~brk_any
        pc = where(to_fast, PC_FAST, pc)
        cur = where(to_fast, 1, cur)
        fired = where(to_fast, False, fired)

        ealive = where(fire_br[:, None], ealive_b, ealive)
        hedge = where(fire_br[:, None, None], hedge_b, hedge)
        nz = where(fire_br[:, None], nz_b, nz)

        # ======================= PC_FAST =========================
        fast_cand = base_triv & cls1_nofast & (bal_r < jump[:, None]) \
            & pos_ge_cur
        m_fa = (pc0 == PC_FAST)
        fa_any = torch.any(fast_cand, dim=1)
        fa_f = first_true(fast_cand, 0)
        fire_fa = m_fa & fa_any
        # pass end
        end_fa = m_fa & ~fa_any
        pc = where(end_fa & fired, PC_BROKEN, pc)
        cur = where(end_fa & fired, 1, cur)
        pc = where(end_fa & ~fired, PC_TV1, pc)
        cur = where(end_fa & ~fired, 1, cur)
        tvr = where(end_fa & ~fired, INFf, tvr)
        tvroot = where(end_fa & ~fired, -1, tvroot)
        fired = where(end_fa, False, fired)

        # ======================= PC_TV1 ==========================
        tv_base = base_triv & cls1_fast & pos_ge_cur
        r_im = tv_base & (bal_r < 1.02)
        m_tv = (pc0 == PC_TV1)
        im_any = torch.any(r_im, dim=1)
        im_f = first_true(r_im, V)
        # window candidates strictly before the immediate fire
        win = tv_base & ~r_im & (varange[None, :] < im_f[:, None])
        rw = where(win, bal_r, INFf)
        inf_col = torch.full((B, 1), INFf, dtype=f64, device=dev)
        cmin_ex = torch.cat(
            [inf_col, torch.cummin(rw, dim=1).values[:, :-1]], dim=1)
        pref = torch.minimum(tvr[:, None], cmin_ex)
        upd = win & (rw <= pref)
        ebrk = upd & (rw < jump[:, None])
        eb_any = torch.any(ebrk, dim=1)
        eb_f = first_true(ebrk, V)
        # positions <= eb_f (and < im_f via the window) update carry;
        # the early-break candidate updates carry, then fires
        upd_eff = upd & (varange[None, :] <= eb_f[:, None])
        new_tvr = torch.amin(where(upd_eff, rw, INFf), dim=1)
        any_upd = torch.any(upd_eff, dim=1)
        last_upd = last_true(upd_eff)
        tvr_n = where(any_upd, torch.minimum(tvr, new_tvr), tvr)
        tvroot_n = where(any_upd, last_upd, tvroot)
        tvr = where(m_tv, tvr_n, tvr)
        tvroot = where(m_tv, tvroot_n, tvroot)

        fire_tv_im = m_tv & im_any & (im_f <= eb_f)
        fire_tv_eb = m_tv & eb_any & (eb_f < im_f)
        end_tv = m_tv & ~im_any & ~eb_any
        end_fire = end_tv & ~fired & (tvroot >= 0)
        # decompose target and return pc
        tv_fire = fire_tv_im | fire_tv_eb | end_fire
        tv_tgt = where(fire_tv_im, im_f,
                             where(fire_tv_eb, eb_f, tvroot))
        tv_ret = where(fire_tv_im, PC_TV1, PC_BROKEN).to(ix)
        tv_retc = where(fire_tv_im, im_f + 1, 1)
        fired = where(fire_tv_im, True, fired)
        # pass ends without fire
        pc = where(end_tv & fired, PC_BROKEN, pc)
        cur = where(end_tv & fired, 1, cur)
        to_small = end_tv & ~fired & (tvroot < 0)
        pc = where(to_small, PC_SMALL, pc)
        cur = where(to_small, 1, cur)
        smr = where(to_small, smallr, smr)
        sme = where(to_small, -1, sme)
        fired = where(end_tv, False, fired)

        # ======================= PC_SMALL ========================
        m_sm = (pc0 == PC_SMALL)
        both_multi = active_v & (din > 1) & (dout > 1)
        in_ok = t["sm_in_e"] >= 0
        out_ok = t["sm_out_e"] >= 0
        r_in = where(in_ok, t["sm_in_w"] / w1, 0.0)
        r_out = where(out_ok, t["sm_out_w"] / w2, 0.0)
        use_in = r_in < r_out
        sm_e = where(in_ok & out_ok,
                           where(use_in, t["sm_in_e"],
                                       t["sm_out_e"]), -1)
        sm_r = where(in_ok & out_ok,
                           where(use_in, r_in, r_out), 0.0)
        smec = torch.clamp(sm_e, 0, E - 1)
        es = rowget(esrc, smec)
        et = rowget(edst, smec)
        deg_ok = (rowget(dout, torch.clamp(es, 0, V - 1)) > 1) \
            & (rowget(din, torch.clamp(et, 0, V - 1)) > 1)
        if any_small:
            lext, rext = extends(hedge, hlen, smec)
        else:
            lext = torch.zeros((B, V), dtype=torch.bool, device=dev)
            rext = lext
        ext_ok = ~(lext & rext)
        at_t = et == varange[None, :]
        at_s = es == varange[None, :]
        ext_ok = ext_ok & ~(at_t & rext) & ~(at_s & lext)
        z = rowget(estr, smec)
        zc = torch.clamp(z, 0, 2).long()
        vs_in0 = t["sin"][:, :, 0]
        vs_out0 = t["sout"][:, :, 0]
        vs_in_z = torch.gather(t["sin"], 2, zc[:, :, None])[:, :, 0]
        vs_out_z = torch.gather(t["sout"], 2, zc[:, :, None])[:, :, 0]
        str_ok = ~(at_s & (z >= 1) & ((vs_in0 + vs_in_z) <= 1)) \
            & ~(at_t & (z >= 1) & ((vs_out0 + vs_out_z) <= 1))
        sm_cand = both_multi & (sm_e >= 0) & deg_ok & ext_ok \
            & str_ok & pos_ge_cur
        sm_im = sm_cand & (sm_r < 0.01)
        sm_im_any = torch.any(sm_im, dim=1)
        sm_im_f = first_true(sm_im, V)
        winm = sm_cand & ~sm_im & (varange[None, :] < sm_im_f[:, None])
        rwm = where(winm, sm_r, INFf)
        cmin_ex_m = torch.cat(
            [inf_col, torch.cummin(rwm, dim=1).values[:, :-1]], dim=1)
        prefm = torch.minimum(smr[:, None], cmin_ex_m)
        updm = winm & (rwm <= prefm)
        any_um = torch.any(updm, dim=1)
        last_um = last_true(updm)
        new_smr = torch.amin(where(updm, rwm, INFf), dim=1)
        smr_n = where(any_um, torch.minimum(smr, new_smr), smr)
        sme_n = where(
            any_um, rowget(sm_e, torch.clamp(last_um, 0, V - 1)), sme)
        smr = where(m_sm, smr_n, smr)
        sme = where(m_sm, sme_n, sme)

        fire_sm_im = m_sm & sm_im_any
        end_sm = m_sm & ~sm_im_any
        end_fire_sm = end_sm & ~fired & (sme >= 0)
        rm_edge = where(fire_sm_im,
                              rowget(sm_e, torch.clamp(sm_im_f, 0, V - 1)),
                              sme)
        do_rm = fire_sm_im | end_fire_sm
        rm_c = torch.clamp(rm_edge, 0, E - 1)
        ealive = rowset(ealive, rm_c, do_rm, False)
        rm_mask = torch.scatter(
            torch.zeros((B, E), dtype=torch.bool, device=dev), 1,
            rm_c.long()[:, None], do_rm[:, None])
        hedge = hs_remove_mask(hedge, hlen, rm_mask)
        larm, ltgt, ndec, ovf_s = logd(larm, ltgt, ndec, do_rm,
                                       SMALLEST, rm_edge)
        fired = where(fire_sm_im, True, fired)
        cur = where(fire_sm_im, sm_im_f + 1, cur)
        # pass ends
        pc = where(end_fire_sm, PC_BROKEN, pc)
        cur = where(end_fire_sm, 1, cur)
        done_sm = end_sm & ~fired & (sme < 0) & ~end_fire_sm
        pc = where(end_sm & fired, PC_BROKEN, pc)
        cur = where(end_sm & fired, 1, cur)
        fired = where(end_sm, False, fired)
        pc = where(done_sm, PC_DONE, pc)
        status = where(done_sm, ST_CLEAN, status)

        # =================== DECOMP trigger ======================
        # (from FAST fire or TV1 fires): balance root, build pairs
        fire_fa_full = fire_fa
        trig = fire_fa_full | tv_fire
        troot = where(fire_fa_full, fa_f, tv_tgt)
        troot_c = torch.clamp(troot, 0, V - 1).long()
        dret = where(fire_fa_full, PC_FAST,
                           where(tv_fire, tv_ret, dret))
        dretc = where(fire_fa_full, fa_f + 1,
                            where(tv_fire, tv_retc, dretc))
        fired = where(fire_fa_full, True, fired)

        # balance_vertex(root) (scallop.cc:2486-2576)
        linr = t["lin"][bi, troot_c]                     # [B,DMAX]
        loutr = t["lout"][bi, troot_c]
        bw1 = t["inw"][bi, troot_c]
        bw2 = t["outw"][bi, troot_c]
        bww = ieee_sqrt(bw1 * bw2)
        r1 = bww / where(bw1 == 0.0, 1.0, bw1)
        r2 = bww / where(bw2 == 0.0, 1.0, bw2)

        def bal_side(lst, rr, w):
            # the list's edges are distinct, so each one's rescaled
            # weight depends on no other; only the surplus m is an
            # ordered sum along the list
            ok = (lst >= 0) & trig[:, None]
            wy = rowget(w, torch.clamp(lst, 0, E - 1)) * rr[:, None]
            low = wy < guard[:, None]
            m = ordered_sum(where(ok & low, guard[:, None] - wy, 0.0))
            wy = where(low, guard[:, None], wy)
            return m, rowset_drop(w, where(ok, lst, E), wy)
        m1, ewrt_b = bal_side(linr, r1, ewrt)
        m2, ewrt_b = bal_side(loutr, r2, ewrt_b)
        ewrt = ewrt_b
        sur_out = torch.clamp(loutr[:, 0], 0, E - 1).long()[:, None]
        sur_in = torch.clamp(linr[:, 0], 0, E - 1).long()[:, None]
        add_out = trig & (m1 > m2)
        add_in = trig & (m1 < m2)
        ewrt = torch.scatter_add(
            ewrt, 1, sur_out, where(add_out, m1 - m2, 0.0)[:, None])
        ewrt = torch.scatter_add(
            ewrt, 1, sur_in, where(add_in, m2 - m1, 0.0)[:, None])

        # pairs: singleton side x multi side, insertion order =
        # multi-side stamp order
        d1r = din[bi, troot_c]
        side = where(d1r == 1, 0, 1).to(ix)
        single_e = where(side == 0, linr[:, 0], loutr[:, 0])
        multi = where(side[:, None] == 0, loutr, linr)
        npairs = torch.sum(multi >= 0, dim=1, dtype=ix)
        sc = torch.clamp(single_e, 0, E - 1)
        w_single = rowget(ewrt, sc)
        mc = torch.clamp(multi, 0, E - 1)
        w_multi = where(multi >= 0, rowget(ewrt, mc), 0.0)
        pw = torch.minimum(w_single[:, None], w_multi)
        # md: singleton accumulates in insertion order; multi = pw
        md_single = ordered_sum(
            where((multi >= 0) & trig[:, None], pw, 0.0))
        ewrt = rowset(ewrt, sc, trig, md_single)
        me_flat = where(multi >= 0, multi, BIGi)
        # invalid pair slots scatter to the dropped column E (duplicate
        # writes to a clipped slot 0 would clobber real weights)
        mc_safe = where((multi >= 0) & trig[:, None], multi, E)
        ewrt = rowset_drop(ewrt, mc_safe, pw)
        # processing order: sorted by (e1,e2) == sorted by multi id
        order_p = torch.argsort(me_flat, dim=1, stable=True)
        multi_s = torch.gather(multi, 1, order_p)
        pw_s = torch.gather(pw, 1, order_p)
        p_e1 = where(side[:, None] == 0, single_e[:, None], multi_s)
        p_e2 = where(side[:, None] == 0, multi_s, single_e[:, None])
        p_e1 = where(multi_s >= 0, p_e1, -1)
        p_e2 = where(multi_s >= 0, p_e2, -1)

        dp_e1 = where(trig[:, None], p_e1, dp_e1)
        dp_e2 = where(trig[:, None], p_e2, dp_e2)
        dp_w = where(trig[:, None], pw_s, dp_w)
        dp_n = where(trig, npairs, dp_n)
        dp_k = where(trig, 0, dp_k)
        dp_ms = where(trig, npairs, dp_ms)
        dside = where(trig, side, dside)
        droot = where(trig, troot, droot)
        pc = where(trig, PC_DECOMP, pc)
        larm, ltgt, ndec, ovf_t = logd(larm, ltgt, ndec, trig,
                                       TRIVIAL, troot)
        # pair/degree capacity
        ovf_cap = trig & ((npairs > DMAX) | t["deg_over"])

        # =================== PC_DECOMP (one pair) ================
        m_dc = (pc0 == PC_DECOMP)   # triggers had pc0 == FAST/TV1
        kc = torch.clamp(dp_k, 0, DMAX - 1)
        pe1 = rowget(dp_e1, kc)
        pe2 = rowget(dp_e2, kc)
        pww = rowget(dp_w, kc)
        do_pair = m_dc & (dp_k < dp_n)
        pe1c = torch.clamp(pe1, 0, E - 1)
        pe2c = torch.clamp(pe2, 0, E - 1)

        ovf_e = do_pair & (nedges + 3 > E)
        ok_pair = do_pair & ~ovf_e

        def split(ei, w, ewrt, esrc, edst, estr, esin, esout,
                  ealive, nedges, nstamp, mask):
            ww = rowget(ewrt, ei)
            keep = torch.abs(ww - w) <= smin
            mk_new = mask & ~keep
            slot = torch.clamp(nedges, 0, E - 1)
            www = ww - w
            www = where(www <= guard, guard, www)
            ewrt = rowset(ewrt, ei, mk_new, www)
            esrc = rowset(esrc, slot, mk_new, rowget(esrc, ei))
            edst = rowset(edst, slot, mk_new, rowget(edst, ei))
            estr = rowset(estr, slot, mk_new, rowget(estr, ei))
            ewrt = rowset(ewrt, slot, mk_new, w)
            esin = rowset(esin, slot, mk_new, nstamp)
            esout = rowset(esout, slot, mk_new, nstamp)
            ealive = rowset(ealive, slot, mk_new, True)
            out = where(mk_new, nedges, ei)
            nedges = nedges + mk_new.to(ix)
            nstamp = nstamp + mk_new.to(ix)
            return out, ewrt, esrc, edst, estr, esin, esout, \
                ealive, nedges, nstamp

        x1, ewrt, esrc, edst, estr, esin, esout, ealive, nedges, \
            nstamp = split(pe1c, pww, ewrt, esrc, edst, estr, esin,
                           esout, ealive, nedges, nstamp, ok_pair)
        y1, ewrt, esrc, edst, estr, esin, esout, ealive, nedges, \
            nstamp = split(pe2c, pww, ewrt, esrc, edst, estr, esin,
                           esout, ealive, nedges, nstamp, ok_pair)
        x1c = torch.clamp(x1, 0, E - 1)
        y1c = torch.clamp(y1, 0, E - 1)
        # merge x1,y1 -> n
        nslot = torch.clamp(nedges, 0, E - 1)
        wx0 = rowget(ewrt, x1c)
        wy0 = rowget(ewrt, y1c)
        esrc = rowset(esrc, nslot, ok_pair, rowget(esrc, x1c))
        edst = rowset(edst, nslot, ok_pair, rowget(edst, y1c))
        ewrt = rowset(ewrt, nslot, ok_pair, wx0 * 0.5 + wy0 * 0.5)
        str_x, str_y = rowget(estr, x1c), rowget(estr, y1c)
        zstr = where(str_y != 0, str_y,
                           where(str_x != 0, str_x, 0))
        estr = rowset(estr, nslot, ok_pair, zstr)
        esin = rowset(esin, nslot, ok_pair, nstamp)
        esout = rowset(esout, nslot, ok_pair, nstamp)
        ealive = rowset(ealive, nslot, ok_pair, True)
        ealive = rowset(ealive, x1c, ok_pair, False)
        ealive = rowset(ealive, y1c, ok_pair, False)
        newe = nedges
        nedges = nedges + ok_pair.to(ix)
        nstamp = nstamp + ok_pair.to(ix)
        # root erasure when isolated (recompute degrees inline)
        rc = torch.clamp(droot, 0, V - 1)
        deg_root = torch.sum(
            ealive & ((edst == rc[:, None]) | (esrc == rc[:, None])),
            dim=1)
        nz = rowset(nz, rc, ok_pair & (deg_root == 0), False)
        # hs updates (original pair ids, new edge id)
        he2, hl2 = hs_replace_pair(hedge, hlen, pe1, pe2, newe)
        hedge = where(ok_pair[:, None, None], he2, hedge)
        hlen = where(ok_pair[:, None], hl2, hlen)
        m_e1 = where(dside == 0, dp_ms, 1)
        m_e2 = where(dside == 0, 1, dp_ms)
        r1m = ok_pair & (m_e1 == 1)
        hr = hs_replace_single(hedge, hlen, pe1, newe)
        hedge = where(r1m[:, None, None], hr, hedge)
        r2m = ok_pair & (m_e2 == 1)
        hr = hs_replace_single(hedge, hlen, pe2, newe)
        hedge = where(r2m[:, None, None], hr, hedge)
        dp_k = dp_k + do_pair.to(ix)

        # decomp end: all pairs processed -> hs_remove pair edges,
        # erase root, return (dp_k already incremented this iteration)
        dend = m_dc & (dp_k >= dp_n)
        in1 = torch.any((earange[None, None, :] == dp_e1[:, :, None])
                        & (dp_e1[:, :, None] >= 0), dim=1)
        in2 = torch.any((earange[None, None, :] == dp_e2[:, :, None])
                        & (dp_e2[:, :, None] >= 0), dim=1)
        prs = (in1 | in2) & dend[:, None]
        hedge = hs_remove_mask(hedge, hlen, prs)
        nz = rowset(nz, rc, dend, False)
        pc = where(dend, dret, pc)
        cur = where(dend, dretc, cur)

        # overflow consolidation
        ovf = ovf_b | ovf_s | ovf_t | ovf_cap | ovf_e
        pc = where(ovf, PC_DONE, pc)
        status = where(ovf, ST_OVERFLOW, status)
        return (esrc, edst, ewrt, estr, esin, esout, ealive, nedges,
                nstamp, nz, hedge, hlen, pc, cur, fired, tvr, tvroot,
                smr, sme, droot, dp_e1, dp_e2, dp_w, dp_n, dp_k,
                dp_ms, dside, dret, dretc, larm, ltgt, ndec, status)

    def finish(state):
        st = dict(zip(STATE_NAMES, state))
        status = where(st["status"] == ST_RUN, ST_OVERFLOW, st["status"])
        i32 = torch.int32
        return (st["larm"].to(i32), st["ltgt"].to(i32), st["ndec"].to(i32),
                status.to(i32), st["ewrt"], st["ealive"],
                st["esrc"].to(i32), st["edst"].to(i32), st["estr"].to(i32),
                st["nedges"].to(i32), st["hedge"].to(i32),
                st["hlen"].to(i32), st["nz"])

    return init, body, finish


def _read_pc(pc):
    """The one host read of an iteration of the plain loop: whether any
    graph still runs, and the guards of the two expensive tables
    (dominates, extends)."""
    pc_host = pc.cpu()
    return (bool((pc_host != PC_DONE).any()),
            bool((pc_host == PC_TV1).any()),
            bool((pc_host == PC_SMALL).any()))


def _shape(args):
    """(B, V, E, H, L) of ladder()'s inputs."""
    B, E = args[0].shape
    return (B, args[9].shape[1], E) + tuple(args[10].shape[1:])


def _count(counters, events):
    """Add a dispatch's lockstep iteration count, the largest per-graph
    event count, to counters["ladder_iterations"]."""
    if counters is not None:
        it = int(events.max()) if events.numel() else 0
        counters["ladder_iterations"] = \
            counters.get("ladder_iterations", 0) + it


def ladder_plain(esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp,
                 nz, hedge, hlen, nv, jump, smallr, guard, smin,
                 DMAX=DEFAULT_DMAX, DLOG=DEFAULT_DLOG, maxiter=None,
                 counters=None, with_events=False):
    """The ladder prefix of every graph of the batch in plain PyTorch, on
    any device, each operation launched as it comes: every graph advances
    one event a step, in lockstep, and the host reads pc once a step.

    esrc, edst, estr, esin, esout [B, E] i32, ewrt [B, E] f64, ealive
    [B, E] bool, nedges, nstamp, nv [B] i32, nz [B, V] bool, hedge
    [B, H, L] i32, hlen [B, H] i32, jump, smallr, guard, smin [B] f64, all
    on one device.  Returns (larm, ltgt [B, DLOG] i32, ndec, status [B]
    i32, ewrt, ealive, esrc, edst, estr, nedges, hedge, hlen, nz), and with
    with_events also each graph's event count [B] i32: the steps in which
    it ran, what csrc/ladder.cu counts.  The loop runs as many steps as the
    largest count; with `counters` a dict, that number is added to
    counters["ladder_iterations"]."""
    args = (esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp, nz,
            hedge, hlen, nv, jump, smallr, guard, smin)
    B, V, E, H, L = _shape(args)
    init, body, finish = _build(B, V, E, H, L, DMAX, DLOG, esrc.device)
    state, params = init(*args)
    events = torch.zeros(B, dtype=torch.int32, device=esrc.device)
    it = 0
    maxiter = 4 * V * V if maxiter is None else maxiter
    while it < maxiter:
        running, any_tv1, any_small = _read_pc(state[PC_SLOT])
        if not running:
            break
        events += (state[PC_SLOT] != PC_DONE).to(torch.int32)
        state = body(state, params, any_tv1, any_small)
        it += 1
    _count(counters, events)
    out = finish(state)
    return out + (events,) if with_events else out


# the kernel's inputs: (name, dtype, shape in (B, V, E, H, L) letters)
_IN_SPEC = tuple(zip(ARG_NAMES, (
    (torch.int32, "BE"), (torch.int32, "BE"), (torch.float64, "BE"),
    (torch.int32, "BE"), (torch.int32, "BE"), (torch.int32, "BE"),
    (torch.bool, "BE"), (torch.int32, "B"), (torch.int32, "B"),
    (torch.bool, "BV"), (torch.int32, "BHL"), (torch.int32, "BH"),
    (torch.int32, "B"), (torch.float64, "B"), (torch.float64, "B"),
    (torch.float64, "B"), (torch.float64, "B"))))
# its outputs, in ladder()'s order, then the per-graph event counts
OUT_NAMES = ("larm", "ltgt", "ndec", "status", "ewrt", "ealive", "esrc",
             "edst", "estr", "nedges", "hedge", "hlen", "nz")
_OUT_SPEC = (
    (torch.int32, "BD"), (torch.int32, "BD"), (torch.int32, "B"),
    (torch.int32, "B"), (torch.float64, "BE"), (torch.bool, "BE"),
    (torch.int32, "BE"), (torch.int32, "BE"), (torch.int32, "BE"),
    (torch.int32, "B"), (torch.int32, "BHL"), (torch.int32, "BH"),
    (torch.bool, "BV"), (torch.int32, "B"))


def kernel_args(args, DMAX=DEFAULT_DMAX, DLOG=DEFAULT_DLOG, maxiter=None,
                outs=None):
    """Check ladder()'s 17 inputs for the kernel and allocate its outputs.
    Each input's graph rows may lie at any stride, each row contiguous (the
    solver's views into its packed staging buffer).  `outs`: the outputs
    to write instead, in the order of ladder()'s 13 and the event counts,
    dense, None for an output the kernel is not to store.  Returns (the
    outputs, the C function's arguments but the stream: pointers, the
    shape, the output pointers and the inputs' per-graph strides).  Raises
    on a wrong type, shape, device or layout."""
    if len(args) != len(ARG_NAMES):
        raise TypeError("the ladder takes %d inputs, got %d"
                        % (len(ARG_NAMES), len(args)))
    B, V, E, H, L = _shape(args)
    dims = dict(B=B, V=V, E=E, H=H, L=L, D=DLOG)
    dev = args[0].device
    for (name, (dtype, letters)), t in zip(_IN_SPEC, args):
        shape = tuple(dims[c] for c in letters)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError("%s must be %s %s, got %s %s" % (
                name, dtype, shape, t.dtype, tuple(t.shape)))
        if t.device != dev:
            raise ValueError("%s is on %s, esrc on %s" % (name, t.device,
                                                          dev))
        if not t[:1].is_contiguous():
            raise ValueError("%s must be contiguous in each graph's row"
                             % name)
    if not 1 <= DMAX <= 256 or DLOG < 1:
        raise ValueError("DMAX must be in [1, 256] and DLOG >= 1, got %d, "
                         "%d" % (DMAX, DLOG))
    maxiter = 4 * V * V if maxiter is None else int(maxiter)
    if outs is None:
        outs = tuple(torch.empty(tuple(dims[c] for c in letters),
                                 dtype=dtype, device=dev)
                     for dtype, letters in _OUT_SPEC)
    if len(outs) != len(_OUT_SPEC):
        raise TypeError("the ladder writes %d outputs, got %d"
                        % (len(_OUT_SPEC), len(outs)))
    for name, (dtype, letters), t in zip(OUT_NAMES + ("events",), _OUT_SPEC,
                                         outs):
        shape = tuple(dims[c] for c in letters)
        if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError("output %s must be a contiguous %s %s on %s"
                             % (name, dtype, shape, dev))
    strides = (ctypes.c_longlong * len(args))(
        *(t.stride(0) for t in args))
    c_args = ([t.data_ptr() for t in args] + [B, V, E, H, L, DMAX, DLOG,
                                               maxiter]
              + [None if t is None else t.data_ptr() for t in outs]
              + [strides])
    return outs, c_args


def launch(c_args, dev, prof=None):
    """One launch of the hand-written kernel (csrc/ladder.cu) on the current
    stream of card `dev`, with kernel_args' arguments; with `prof`, a
    zeroed int64 tensor on the card, the profiling instance, which adds
    each pass's cycles to it and is not counted in ladder_cuda.launches.
    No synchronisation."""
    from ._build import load_library
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if prof is None:
            err = lib.aletsch_ladder_f64(*c_args, stream)
        else:
            err = lib.aletsch_ladder_f64_prof(*c_args, prof.data_ptr(),
                                              stream)
    if err != 0:
        raise RuntimeError("ladder kernel launch failed: cudaError %d" % err)
    if prof is None:
        ladder_cuda.launches += 1


def ladder_cuda(*args, DMAX=DEFAULT_DMAX, DLOG=DEFAULT_DLOG, maxiter=None,
                counters=None, with_events=False):
    """ladder_plain's function as one launch of the hand-written kernel
    (csrc/ladder.cu) on the current stream of the inputs' card: every graph
    runs to its end on the card, one block a graph, with no host read in
    between.  CUDA tensors of ladder_plain's types only, each graph's row
    contiguous.  With `counters`, the largest event count is read back (one
    sync) and added to counters["ladder_iterations"]."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError("ladder_cuda takes CUDA tensors, got %s" % dev)
    outs, c_args = kernel_args(args, DMAX, DLOG, maxiter)
    if args[0].shape[0] > 0:
        launch(c_args, dev)
    _count(counters, outs[-1])
    return outs if with_events else outs[:-1]


ladder_cuda.launches = 0    # kernel launches since the last reset

# the profiling instance's passes (csrc/ladder_machine.cuh, P_BUILD ..
# P_APPLY) and pc kinds: its output is cycles[pass][pc], then events[pc]
PROF_PASSES = ("build", "lists", "flags", "hyper queries", "event", "post",
               "pair", "entries")
PROF_PCS = ("broken", "fast", "tv1", "small", "decomp")


def ladder_profile(*args, DMAX=DEFAULT_DMAX, DLOG=DEFAULT_DLOG,
                   maxiter=None):
    """One launch of the kernel's profiling instance (never on the main
    path; not counted in ladder_cuda.launches): ladder_cuda's outputs with
    the event counts, and the clock64() cycles each pass took, summed over
    the graphs, as an int64 array [passes, pcs] beside the events [pcs]."""
    npc = len(PROF_PCS)
    prof = torch.zeros((len(PROF_PASSES) + 1) * npc, dtype=torch.int64,
                       device=args[0].device)
    outs, c_args = kernel_args(args, DMAX, DLOG, maxiter)
    launch(c_args, args[0].device, prof)
    p = prof.cpu().numpy()
    return outs, p[:-npc].reshape(len(PROF_PASSES), npc), p[-npc:]


def ladder(*args, **kw):
    """The ladder on its inputs' device: plain PyTorch for CPU tensors,
    the kernel for CUDA tensors (which raises rather than fall back).
    Keywords as ladder_plain's."""
    if args[0].device.type == "cpu":
        return ladder_plain(*args, **kw)
    return ladder_cuda(*args, **kw)


def pack_states(states, B, V, E, H, L):
    """Pack a list of ladder_ref.LadderState into batch arrays (None
    entries become inactive rows)."""
    arr = dict(
        esrc=np.full((B, E), -1, np.int32),
        edst=np.full((B, E), -1, np.int32),
        ewrt=np.zeros((B, E), np.float64),
        estr=np.zeros((B, E), np.int32),
        esin=np.zeros((B, E), np.int32),
        esout=np.zeros((B, E), np.int32),
        ealive=np.zeros((B, E), bool),
        nedges=np.zeros(B, np.int32),
        nstamp=np.zeros(B, np.int32),
        nz=np.zeros((B, V), bool),
        hedge=np.full((B, H, L), -1, np.int32),
        hlen=np.zeros((B, H), np.int32),
        nv=np.zeros(B, np.int32),
        jump=np.zeros(B, np.float64),
        smallr=np.zeros(B, np.float64),
        guard=np.zeros(B, np.float64),
        smin=np.zeros(B, np.float64),
    )
    for b, st in enumerate(states):
        if st is None:
            continue
        ne = st.n_edges
        arr["esrc"][b, :ne] = st.e_src[:ne]
        arr["edst"][b, :ne] = st.e_dst[:ne]
        arr["ewrt"][b, :ne] = st.e_wrt[:ne]
        arr["estr"][b, :ne] = st.e_str[:ne]
        arr["esin"][b, :ne] = st.e_in_stamp[:ne]
        arr["esout"][b, :ne] = st.e_out_stamp[:ne]
        arr["ealive"][b, :ne] = st.e_alive[:ne]
        arr["nedges"][b] = ne
        arr["nstamp"][b] = st.next_stamp
        arr["nz"][b, :st.nv] = st.nonzero
        nh = st.n_hyper
        arr["hedge"][b, :nh] = st.h_edge[:nh]
        arr["hlen"][b, :nh] = st.h_len[:nh]
        arr["nv"][b] = st.nv
        arr["jump"][b] = st.jump_ratio
        arr["smallr"][b] = st.small_ratio
        arr["guard"][b] = st.guard
        arr["smin"][b] = st.smin
    return arr


def batch_from_numpy(arr, device):
    """The dict of arrays pack_states returns as ladder()'s tensors on
    `device`, in its argument order."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(arr[k])).to(dev)
                 for k in ARG_NAMES)


def run_kernel(states, B=None, V=DEFAULT_V, E=DEFAULT_E, H=DEFAULT_H,
               L=DEFAULT_L, DMAX=DEFAULT_DMAX, DLOG=DEFAULT_DLOG,
               device="cpu", counters=None):
    """Convenience wrapper: pack, dispatch on `device`, unpack per-graph
    decision logs [(arm, tgt)] + statuses + final dense fields."""
    if B is None:
        B = max(1, len(states))
    arr = pack_states(states, B, V, E, H, L)
    out = ladder(*batch_from_numpy(arr, device), DMAX=DMAX, DLOG=DLOG,
                 counters=counters)
    out = [o.cpu().numpy() for o in out]
    larm, ltgt, ndec, status = out[:4]
    logs = []
    for b in range(len(states)):
        n = int(ndec[b])
        logs.append([(int(larm[b, i]), int(ltgt[b, i]))
                     for i in range(min(n, DLOG))])
    return logs, status, out[4:]


# ------------------------------------------------------------ fuzz states

def _stamp(gr, rng=None):
    for e in gr.edges():
        ei = gr.get_edge_info(e)
        ei.samples = {0}
        ei.spAbd = {0: gr.get_edge_weight(e)}
        ei.abd = gr.get_edge_weight(e)
        ei.count = 1
        if rng is not None:
            ei.strand = rng.choice([0, 0, 0, 1, 2])


def _random_phase_paths(gr, rng, n_paths):
    from ..scallop.hyper_set import HyperSet
    hs = HyperSet()
    n = gr.num_vertices() - 1
    for _ in range(n_paths):
        v = 0
        path = []
        while v != n:
            outs = gr.out_edges(v)
            if not outs:
                break
            e = rng.choice(outs)
            v = e.t
            if v != n:
                path.append(v)
        if len(path) >= 2:
            hs.add_node_list(path, rng.randint(2, 10))
    return hs


def fuzz_scallop(seed):
    """A seeded random Scallop (post-init, pre-ladder) over a simulated
    splice graph with random phasing paths, every third one with random
    edge strands; None when the graph came out empty."""
    from ..config import Parameters
    from ..core.graph_io import simulate_graph
    from ..scallop.decompose import Scallop
    rng = random.Random(seed)
    nv = rng.randint(6, 24)
    ne = rng.randint(nv, 3 * nv)
    gr = simulate_graph(nv, ne, 100, seed=seed)
    if gr.num_edges() == 0:
        return None
    _stamp(gr, rng if seed % 3 == 0 else None)
    hs = _random_phase_paths(gr, rng, rng.randint(0, 8))
    hs.filter_nodes(gr)
    return Scallop(gr, hs, Parameters())


def fuzz_states(seeds, V=DEFAULT_V, E=DEFAULT_E, H=DEFAULT_H, L=DEFAULT_L):
    """(refs, states): two equal lists of dense ladder states, one for
    ladder_ref.run_ladder (which consumes its state) and one for
    pack_states, for every seed whose graph fits the shape."""
    refs, states = [], []
    for seed in seeds:
        pair = []
        for _ in range(2):
            sc = fuzz_scallop(seed)
            st = None if sc is None else ladder_ref.export_scallop(
                sc, emax=E, hmax=H, lmax=L)
            if st is None or st.nv > V:
                break
            pair.append(st)
        if len(pair) == 2:
            refs.append(pair[0])
            states.append(pair[1])
    return refs, states


def fixture_state(directory, name, E=DEFAULT_E, H=DEFAULT_H, L=DEFAULT_L):
    """The dense ladder state of the ladder fixture `name` in `directory`
    (the repository's tests/fixtures/ladder: <name>.graph in the
    reference's text format, <name>.phase its phasing paths), or None
    when the export refuses it.  Here beside fuzz_states for the reason
    drain.fuzz_batch gives."""
    import os

    from ..config import Parameters
    from ..core.graph_io import read_graph_reference
    from ..scallop.decompose import Scallop
    from ..scallop.hyper_set import HyperSet
    gr = read_graph_reference(os.path.join(directory, name + ".graph"))
    gr.chrm, gr.gid, gr.strand = "1", name, "+"
    _stamp(gr)
    hs = HyperSet()
    phase = os.path.join(directory, name + ".phase")
    if os.path.exists(phase):
        with open(phase) as fh:
            for line in fh:
                parts = [int(x) for x in line.split()]
                hs.add_node_list(parts[1:], parts[0])
    return ladder_ref.export_scallop(Scallop(gr, hs, Parameters()),
                                     emax=E, hmax=H, lmax=L)


def fixture_names(directory):
    """The ladder fixtures' names (those of expected.json), sorted."""
    import json
    import os
    with open(os.path.join(directory, "expected.json")) as fh:
        return sorted(json.load(fh))


def fixture_states(directory, V=DEFAULT_V, E=DEFAULT_E, H=DEFAULT_H,
                   L=DEFAULT_L):
    """fixture_state of every ladder fixture in `directory` whose graph
    fits the shape, in name order."""
    states = []
    for name in fixture_names(directory):
        st = fixture_state(directory, name, E, H, L)
        if st is not None and st.nv <= V:
            states.append(st)
    return states
