// The per-graph machine of the resolution-ladder kernel (ladder.cu): one
// graph's state in shared memory, its per-event tables and its events.
//
// nvcc compiles it for the card, where a block of THREADS threads runs one
// graph; a host compiler compiles the same code for nt std::threads
// (ladder_host.cpp), where the block primitives (ladder_block.cuh) take
// their host form: the CPU tests hold that build, at one thread and at
// several, against the plain PyTorch form, so the transcription and the
// split of every parallel pass are tested where no card is.  Both builds
// must keep every f64 product and sum a rounding of its own: nvcc
// -fmad=false, g++ -ffp-contract=off.
//
// An event is a sequence of passes, each ended by a barrier that every
// thread of the block reaches (run_graph):
//   build_degrees  degrees by atomics over the live edges, each edge landing
//                  in its vertex's bucket at the slot its count gave it
//                  (1 barrier);
//   build_lists    each edge's rank in its vertex's stamp-ordered list,
//                  counted inside the bucket (1);
//   list_tables    each adjacency list's ordered sum and smallest edge on a
//                  thread of its own (1; 2 more when the hyper lists'
//                  occurrence index is rebuilt beside it);
//   flags          each vertex's candidate flags, the hyper queries through
//                  the index, and the block's first candidate (1);
//   event          thread 0 applies the event from those tables (1);
//   post           the arm's passes over the edges, on every thread, from
//                  what thread 0 left in Scal (1, in the events that have
//                  one);
//   apply_pair     the event's pair replacement, a row a thread (a row a
//                  warp on the card) (1, in the events that have one);
//   apply_entries  its single replacements and removals, an entry a
//                  thread, and the tables cleared for the next event (1).
// A pair of a decomposition reads no table and builds none; the broken
// arm reads only the degrees.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "ladder_block.cuh"

namespace ladder {

// pc values and statuses (ops/ladder_kernel.py)
constexpr int PC_BROKEN = 0;
constexpr int PC_FAST = 1;
constexpr int PC_TV1 = 2;
constexpr int PC_SMALL = 3;
constexpr int PC_DECOMP = 4;
constexpr int PC_DONE = 5;
constexpr int ST_RUN = -1;
constexpr int ST_CLEAN = 0;
constexpr int ST_OVERFLOW = 1;
// decision arms (ops/ladder_ref.py)
constexpr int ARM_BROKEN = 0;
constexpr int ARM_TRIVIAL = 1;
constexpr int ARM_SMALLEST = 2;

constexpr double INF = 1e300;
constexpr int BIGI = 1 << 30;
// the largest DMAX: a decomposition's scratch weights (Scratch) hold this
// many
constexpr int MAX_DMAX = 256;

// per-vertex candidate flags of one event
constexpr uint8_t F_BROKEN = 1;     // broken-vertex candidate
constexpr uint8_t F_FAST = 2;       // fast trivial candidate
constexpr uint8_t F_TV = 4;         // trivial-vertex scan base
constexpr uint8_t F_SMALL = 8;      // smallest-edge candidate

// the profiling instance's passes, and its output: cycles[pass][pc] then
// events[pc], summed over the graphs of a launch
constexpr int P_BUILD = 0;      // build_degrees, build_lists
constexpr int P_LISTS = 1;      // list_tables
constexpr int P_FLAGS = 2;      // the flags but the hyper queries
constexpr int P_HYPER = 3;      // the occurrence index and the queries
constexpr int P_EVENT = 4;      // event (thread 0)
constexpr int P_POST = 5;       // its post pass
constexpr int P_PAIR = 6;       // apply_pair
constexpr int P_APPLY = 7;      // apply_entries
constexpr int NPASS = 8;
constexpr int NPC = 5;
constexpr int NPROF = NPASS * NPC + NPC;

struct Prof {
    unsigned long long acc[NPROF];
    unsigned long long hq;      // this event's longest hyper-query time
};

struct Shape {
    int V, E, H, L, DMAX, DLOG;
};

// The pitches of the hyper rows and of the adjacency lists in shared
// memory: odd, so that the threads of a warp walking 32 rows (lists) side
// by side hit 32 banks.
LADDER_HD int lpitch(const Shape& s) { return s.L | 1; }
LADDER_HD int dpitch(const Shape& s) { return s.DMAX | 1; }

// the 17 inputs, [B, ...] with graph b's row at b * st[i] elements of
// input i (in this order), each row contiguous
struct In {
    const int *esrc, *edst;
    const double* ewrt;
    const int *estr, *esin, *esout;
    const uint8_t* ealive;
    const int *nedges, *nstamp;
    const uint8_t* nz;
    const int *hedge, *hlen, *nv;
    const double *jump, *smallr, *guard, *smin;
    long long st[17];
};

// the 13 outputs and the per-graph event counts, [B, ...] row-major; a
// null pointer is an output not stored
struct Out {
    int *larm, *ltgt, *ndec, *status;
    double* ewrt;
    uint8_t* ealive;
    int *esrc, *edst, *estr, *nedges, *hedge, *hlen;
    uint8_t* nz;
    int* events;
};

// the loop's scalar state, the graph's parameters, what the event leaves
// for the post pass (kill: the broken vertex whose edges die, root: the
// vertex whose degree decides its erasure; -1 where none) and the
// hyper-list updates for the whole block (apply_pair, apply_entries):
// replace the pair [hx, hy] by he, then the single hx1 and the single hx2
// by he, then remove the edges whose emark is this event's mark, each
// where its flag is set.  stale: the hyper lists changed since the
// occurrence index was built; degover: some degree of this event's tables
// exceeds DMAX.
struct Scal {
    int pc, cur, fired, tvroot, sme, droot, dp_n, dp_k, dp_ms, dside, dret,
        dretc, ndec, status, nedges, nstamp, it, nv;
    int kill, root, mark, stale, degover;
    int do_pair, do_s1, do_s2, do_rm, hx, hy, hx1, hx2, he;
    double tvr, smr, jump, smallr, guard, smin;
};

// the weights a decomposition's start rewrites (thread 0)
struct Scratch {
    double wy[MAX_DMAX];
};

// the graph's arrays in (dynamic shared) memory.  deg: the in-degrees
// (din = deg) then the out-degrees (dout = deg + V); bucket: each vertex's
// first DMAX live in-edges, then out-edges, in no order, at bucket + v *
// dpitch (V + v for the out-edges).  The occurrence index: the
// (row, position) entries of the hyper lists, packed row * L + position,
// grouped by edge in occ (edge e's at occ[occ_ofs[e], occ_ofs[e + 1])),
// occ_cnt the count pass's (0 between builds).  Hyper row h starts at
// hedge + h * lpitch, vertex v's list at lin (lout) + v * dpitch; llen:
// each list's length (its last slot taken + 1; every slot behind is
// empty), in-lists then out-lists.  emark: the event that last marked each
// edge for removal from the hyper lists.
struct Smem {
    double *ewrt, *inw, *outw, *sm_in_w, *sm_out_w, *balr, *smr_v, *dp_w;
    int *esrc, *edst, *estr, *esin, *esout, *hedge, *hlen, *larm, *ltgt;
    int *lin, *lout, *deg, *din, *dout, *sm_in_e, *sm_out_e, *sin3, *sout3;
    int *sme_v, *dp_e1, *dp_e2, *bucket;
    int *occ_cnt, *occ_ofs, *occ, *llen;
    int* emark;
    uint8_t *flag, *ealive, *nz;
};

LADDER_HD size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// Smem's arrays laid out from base (f64 first, then i32, then u8, flag
// first among those: thread 0 reads it a word at a time, and it is padded
// to whole words); returns the bytes they take.  base == nullptr computes
// the size only.
LADDER_HD size_t carve(char* base, const Shape& s, Smem* m) {
    size_t off = 0;
    const size_t V = s.V, E = s.E, HL = (size_t)s.H * s.L, D = s.DMAX;
    const size_t HP = (size_t)s.H * lpitch(s), VD = V * dpitch(s);
    double* d[8];
    const size_t dn[8] = {E, V, V, V, V, V, V, D};
    for (int i = 0; i < 8; ++i) {
        d[i] = base ? (double*)(base + off) : nullptr;
        off += dn[i] * sizeof(double);
    }
    int* q[25];
    const size_t qn[25] = {E, E, E, E, E, HP, (size_t)s.H, (size_t)s.DLOG,
                           (size_t)s.DLOG, VD, VD, 2 * V, V, V, 3 * V,
                           3 * V, V, D, D, 2 * VD, E, E + 1, HL, 2 * V, E};
    for (int i = 0; i < 25; ++i) {
        q[i] = base ? (int*)(base + off) : nullptr;
        off += qn[i] * sizeof(int);
    }
    uint8_t* u[3];
    const size_t un[3] = {round4(V), E, V};
    for (int i = 0; i < 3; ++i) {
        u[i] = base ? (uint8_t*)(base + off) : nullptr;
        off += un[i];
    }
    if (m) {
        m->ewrt = d[0]; m->inw = d[1]; m->outw = d[2]; m->sm_in_w = d[3];
        m->sm_out_w = d[4]; m->balr = d[5]; m->smr_v = d[6]; m->dp_w = d[7];
        m->esrc = q[0]; m->edst = q[1]; m->estr = q[2]; m->esin = q[3];
        m->esout = q[4]; m->hedge = q[5]; m->hlen = q[6]; m->larm = q[7];
        m->ltgt = q[8]; m->lin = q[9]; m->lout = q[10]; m->deg = q[11];
        m->din = q[11]; m->dout = q[11] ? q[11] + s.V : nullptr;
        m->sm_in_e = q[12]; m->sm_out_e = q[13]; m->sin3 = q[14];
        m->sout3 = q[15]; m->sme_v = q[16]; m->dp_e1 = q[17];
        m->dp_e2 = q[18]; m->bucket = q[19]; m->occ_cnt = q[20];
        m->occ_ofs = q[21]; m->occ = q[22]; m->llen = q[23];
        m->emark = q[24];
        m->flag = u[0]; m->ealive = u[1]; m->nz = u[2];
    }
    return off;
}

LADDER_HD int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

LADDER_HD int imax(int a, int b) { return a > b ? a : b; }

// torch.minimum on values that are not NaN
LADDER_HD double dmin(double a, double b) { return b < a ? b : a; }

// f(h, l) for this thread's entries of an H x L grid, entry i = h L + l
// for i = tid, tid + nt, ...: one division, then steps of nt.
template <class F>
LADDER_FN void each_entry(const Blk& b, int H, int L, F f) {
    const int dh = b.nt / L, dl = b.nt - dh * L;
    int h = b.tid / L, l = b.tid - h * L;
    while (h < H) {
        f(h, l);
        l += dl;
        h += dh;
        if (l >= L) {
            l -= L;
            ++h;
        }
    }
}

// ------------------------------------------------------ hyper-list queries
//
// ops/ladder_kernel.py::dominates and ::extends read every entry of every
// hyper list; here each query visits only the occurrences of its edge, from
// the occurrence index.  Each returns an OR or an AND over occurrences, so
// the order of the index does not matter.

// Entry l of a hyper row read left to right, or (right) in the reverse of
// its valid prefix of length ln.
LADDER_HD int hat(const int* row, int ln, int l, bool right) {
    return right ? row[ln - 1 - l] : row[l];
}

// one occurrence of an edge: its row, the row's valid length, and its
// index l in the row read in the query's direction
struct Occ {
    const int* row;
    int ln, l;
};

LADDER_FN Occ occ_at(const Smem& m, const Shape& s, int packed, bool right) {
    const int h = packed / s.L, p = packed - h * s.L;
    const int ln = clampi(m.hlen[h], 0, s.L);
    return Occ{m.hedge + h * lpitch(s), ln, right ? ln - 1 - p : p};
}

// Whether some occurrence of ec that is not the start of a run (an "x2")
// is followed by n1, and by n2 too unless n2 == -1.
LADDER_FN bool has_x2(const Smem& m, const Shape& s, int ec, bool right,
                      int n1, int n2) {
    for (int i = m.occ_ofs[ec]; i < m.occ_ofs[ec + 1]; ++i) {
        const Occ o = occ_at(m, s, m.occ[i], right);
        const int l = o.l, ln = o.ln;
        if (l < 1 || l + 1 >= ln || hat(o.row, ln, l - 1, right) == -1)
            continue;
        if (hat(o.row, ln, l + 1, right) != n1)
            continue;       // also skips -1: n1 != -1
        const int n2x = l + 2 < ln ? hat(o.row, ln, l + 2, right) : -1;
        if (n2 == -1 || n2x == n2)
            return true;
    }
    return false;
}

// left_dominate (right = false) / right_dominate (right = true) of edge ec
// (hyper_set.cc:1003-1082; ops/ladder_kernel.py::dominates): every
// occurrence of ec that starts a run and has a successor n1 (then n2, or
// -1) must be matched by a non-starting occurrence followed by n1, and by
// n2 when n2 != -1.
LADDER_FN bool dominates(const Smem& m, const Shape& s, int ec, bool right) {
    for (int i = m.occ_ofs[ec]; i < m.occ_ofs[ec + 1]; ++i) {
        const Occ o = occ_at(m, s, m.occ[i], right);
        const int l = o.l, ln = o.ln;
        if (l + 1 >= ln)
            continue;
        const int n1 = hat(o.row, ln, l + 1, right);
        if (n1 == -1)
            continue;
        if (l > 0 && hat(o.row, ln, l - 1, right) != -1)
            continue;       // not a start: an x2 entry
        const int n2 = l + 2 < ln ? hat(o.row, ln, l + 2, right) : -1;
        if (!has_x2(m, s, ec, right, n1, n2))
            return false;
    }
    return true;
}

// (left_extend, right_extend) of edge ec: some occurrence has a
// predecessor / a successor that is not -1.
LADDER_FN void extends(const Smem& m, const Shape& s, int ec, bool* le,
                       bool* re) {
    bool l_ = false, r_ = false;
    for (int i = m.occ_ofs[ec]; i < m.occ_ofs[ec + 1]; ++i) {
        const Occ o = occ_at(m, s, m.occ[i], false);
        l_ = l_ || (o.l > 0 && o.row[o.l - 1] != -1);
        r_ = r_ || (o.l + 1 < o.ln && o.row[o.l + 1] != -1);
    }
    *le = l_;
    *re = r_;
}

// The occurrence index of the hyper lists as they are: every entry of a
// valid prefix that names an edge (0 <= entry < E; no query asks for
// another) counted, the counts scanned, the entries scattered.  occ_cnt
// must be 0 on entry; the scatter leaves it 0.  Three barriers.
LADDER_FN void occ_count(Smem& m, const Shape& s, const Blk& b) {
    each_entry(b, s.H, s.L, [&](int h, int p) {
        const int x = m.hedge[h * lpitch(s) + p];
        if (p < m.hlen[h] && x >= 0 && x < s.E)
            atomic_add(&m.occ_cnt[x], 1);
    });
}

LADDER_FN void occ_scatter(Smem& m, const Shape& s, Blk& b) {
    blk_scan(b, m.occ_cnt, m.occ_ofs, s.E);
    each_entry(b, s.H, s.L, [&](int h, int p) {
        const int x = m.hedge[h * lpitch(s) + p];
        if (p < m.hlen[h] && x >= 0 && x < s.E)
            m.occ[m.occ_ofs[x] + atomic_sub(&m.occ_cnt[x], 1) - 1] =
                h * s.L + p;
    });
    b.sync();
}

// ---------------------------------------------------- hyper-list updates

// Row h, replace_list([x, y], e): each [x, y] (matched on the row as it
// was) becomes [e]; the row is compacted and padded with -1 behind its
// new length.  In place: step l reads entries l and l + 1 before it writes
// entry k <= l.
LADDER_FN void hs_replace_pair(Smem& m, const Shape& s, int h, int x, int y,
                               int e) {
    int* row = m.hedge + h * lpitch(s);
    const int n = m.hlen[h];
    // a row with no [x, y], a length in [0, L] and -1 behind it comes out
    // as it was: read it first, and leave it
    bool same = n >= 0 && n <= s.L;
    for (int l = 0; l < s.L; ++l)
        same = same && (l < n ? !(l + 1 < n && row[l] == x && row[l + 1] == y)
                              : row[l] == -1);
    if (same)
        return;
    int k = 0;
    bool prev_match = false;
    for (int l = 0; l < s.L; ++l) {
        const bool valid = l < n;
        const int cur = row[l];
        const bool match = valid && l + 1 < s.L && l + 1 < n && cur == x
            && row[l + 1] == y;
        const bool keep = valid && !prev_match;
        prev_match = match;
        if (keep)
            row[k++] = match ? e : cur;
    }
    for (int l = k; l < s.L; ++l)
        row[l] = -1;
    m.hlen[h] = k;
}

#ifdef __CUDACC__
// hs_replace_pair of row h by the 32 lanes of a warp, a chunk of 32 entries
// at a time: each lane reads its entry and the next of the row as it was,
// ballots give each kept entry its place (a match drops the entry behind
// it), and the kept entries land at their places, all at or before their
// own, so no later chunk's entries are written before they are read.  A
// row without x in its valid prefix, of a length in [0, L] and -1 behind
// it, comes out as it was, and is left after one vote.
__device__ void hs_replace_pair_warp(Smem& m, const Shape& s, int h, int x,
                                     int y, int e) {
    const unsigned all = 0xffffffffu;
    const int lane = threadIdx.x & 31, L = s.L;
    int* row = m.hedge + h * lpitch(s);
    const int n = m.hlen[h];
    bool change = n < 0 || n > L;
    for (int c = 0; c < L && !change; c += 32) {
        const int l = c + lane;
        const int cur = l < L ? row[l] : -1;
        change = __any_sync(all, l < n ? cur == x : cur != -1);
    }
    if (!change)
        return;
    int k0 = 0;
    bool carry = false;     // whether the previous chunk's last entry matched
    for (int c = 0; c < L; c += 32) {
        const int l = c + lane;
        const int cur = l < L ? row[l] : -1;
        const int nxt = l + 1 < L ? row[l + 1] : -1;
        const bool valid = l < L && l < n;
        const bool match = valid && l + 1 < L && l + 1 < n && cur == x
            && nxt == y;
        const unsigned mm = __ballot_sync(all, match);
        const bool prev = lane == 0 ? carry : ((mm >> (lane - 1)) & 1u);
        const bool keep = valid && !prev;
        const unsigned km = __ballot_sync(all, keep);
        __syncwarp();
        if (keep)
            row[k0 + __popc(km & ((1u << lane) - 1u))] = match ? e : cur;
        __syncwarp();
        k0 += __popc(km);
        carry = (mm >> 31) & 1u;
    }
    for (int l = k0 + lane; l < L; l += 32)
        row[l] = -1;
    if (lane == 0)
        m.hlen[h] = k0;
}
#endif

// The event's hyper-list updates, in the plain form's order on each row:
// first replace the pair, a row a thread (a row a warp on the card).
// Nothing of the event reads the hyper lists after it updates them.
LADDER_FN void apply_pair(Smem& m, const Scal& g, const Shape& s,
                          const Blk& b) {
    if (!g.do_pair)
        return;
#ifdef __CUDACC__
    for (int h = b.tid >> 5; h < s.H; h += b.nt >> 5)
        hs_replace_pair_warp(m, s, h, g.hx, g.hy, g.he);
#else
    for (int h = b.tid; h < s.H; h += b.nt)
        hs_replace_pair(m, s, h, g.hx, g.hy, g.he);
#endif
    b.sync();
}

// Then, entry by entry over the whole block (each depends on its entry and
// its row's length only), replace the single hx1, the single hx2 and
// remove the edges marked for this event (emark), in the valid prefix.
// Then the tables the event built (level 1: the degrees, 2: the lists too)
// are cleared for the next event's.
LADDER_FN void apply_entries(Smem& m, const Scal& g, const Shape& s,
                             const Blk& b, int level) {
    if (g.do_s1 || g.do_s2 || g.do_rm)
        each_entry(b, s.H, s.L, [&](int h, int l) {
            if (l >= m.hlen[h])
                return;
            int* at = m.hedge + h * lpitch(s) + l;
            int v = *at;
            if (g.do_s1 && v == g.hx1)
                v = g.he;
            if (g.do_s2 && v == g.hx2)
                v = g.he;
            if (g.do_rm && v >= 0 && m.emark[v < s.E ? v : s.E - 1] == g.mark)
                v = -1;
            *at = v;
        });
    if (level >= 1) {
        for (int i = b.tid; i < 3 * s.V; i += b.nt) {
            m.sin3[i] = 0;
            m.sout3[i] = 0;
        }
        for (int i = b.tid; i < 2 * s.V; i += b.nt)
            m.deg[i] = 0;
    }
    if (level >= 2)
        for (int i = b.tid; i < 2 * s.V; i += b.nt) {
            // only a list's first llen slots were taken
            const bool out = i >= s.V;
            const int v = out ? i - s.V : i;
            int* lst = (out ? m.lout : m.lin) + v * dpitch(s);
            for (int j = 0; j < m.llen[i]; ++j)
                lst[j] = -1;
            m.llen[i] = 0;
        }
}

// ------------------------------------------------------------- the event

// Append a decision; true when the log overflows (the last slot takes
// every decision past DLOG, as the plain form's clamped slot does).
LADDER_FN bool logd(Smem& m, Scal& g, const Shape& s, int arm, int tgt) {
    const int slot = clampi(g.ndec, 0, s.DLOG - 1);
    m.larm[slot] = arm;
    m.ltgt[slot] = tgt;
    g.ndec += 1;
    return g.ndec > s.DLOG;
}

// split_edge of a decomposition pair: returns the edge that carries w.
LADDER_FN int split(Smem& m, Scal& g, const Shape& s, int ei, double w,
                    bool mask) {
    const double ww = m.ewrt[ei];
    const bool keep = fabs(ww - w) <= g.smin;
    if (!(mask && !keep))
        return ei;
    const int slot = clampi(g.nedges, 0, s.E - 1);
    double www = ww - w;
    if (www <= g.guard)
        www = g.guard;
    m.ewrt[ei] = www;
    m.esrc[slot] = m.esrc[ei];
    m.edst[slot] = m.edst[ei];
    m.estr[slot] = m.estr[ei];
    m.ewrt[slot] = w;
    m.esin[slot] = g.nstamp;
    m.esout[slot] = g.nstamp;
    m.ealive[slot] = 1;
    const int out = g.nedges;
    g.nedges += 1;
    g.nstamp += 1;
    return out;
}

// balance_vertex's rescale of one side of the root, a list of length n:
// returns the side's surplus m (an ordered sum along the list); the
// weights are rewritten.
LADDER_FN double bal_side(Smem& m, const Scal& g, const Shape& s,
                          const int* lst, int n, double rr, double* wy) {
    double acc = 0.0;
    for (int j = 0; j < n; ++j) {
        const bool ok = lst[j] >= 0;
        const double w = m.ewrt[clampi(lst[j], 0, s.E - 1)] * rr;
        const bool low = w < g.guard;
        acc = acc + ((ok && low) ? g.guard - w : 0.0);
        wy[j] = low ? g.guard : w;
    }
    for (int j = 0; j < n; ++j)
        if (lst[j] >= 0)
            m.ewrt[lst[j]] = wy[j];
    return acc;
}

// The next vertex v in [from, to) whose flag has a bit of `bit`, or to.
// Reads the flags a word at a time (carve pads them to whole words with
// bytes that stay 0).
LADDER_FN int next_flagged(const Smem& m, int from, int to, uint8_t bit) {
    const uint32_t* w = (const uint32_t*)m.flag;
    const uint32_t mask = bit * 0x01010101u;
    for (int v = from; v < to;) {
        uint32_t x = w[v >> 2] & mask & (0xffffffffu << (8 * (v & 3)));
        if (x) {
            int i = 0;
            while (!(x & 0xffu)) {
                x >>= 8;
                ++i;
            }
            const int u = (v & ~3) + i;
            return u < to ? u : to;
        }
        v = (v & ~3) + 4;
    }
    return to;
}

// One event of the graph (thread 0), on the tables of this iteration and
// the block's first candidate of the arm that runs (V if none), on a copy
// of the scalar state in registers, written back at the end.  The passes
// over the edges that follow a decision are left to the post pass: the
// event sets kill and root, and marks (emark) the edges it removes from the
// hyper lists itself.
LADDER_FN void event(Smem& m, Scal& gs, const Shape& s, Scratch& x,
                     int first) {
    const int V = s.V, E = s.E, DMAX = s.DMAX;
    Scal g = gs;
    const int pc0 = g.pc;
    g.do_pair = g.do_s1 = g.do_s2 = g.do_rm = 0;
    g.kill = g.root = -1;
    g.mark = g.it;
    bool ovf = false;
    bool trig = false;
    bool fire_fa = false;
    int fa_f = 0, tv_tgt = 0, tv_ret = 0, tv_retc = 0;

    if (pc0 == PC_BROKEN) {
        const int bx = first < V ? first : -1;
        if (bx >= 0) {
            g.kill = bx;        // the post pass masks and kills its edges
            g.do_rm = 1;
            m.nz[bx] = 0;
            ovf = logd(m, g, s, ARM_BROKEN, bx) || ovf;
        } else {
            g.pc = PC_FAST;
            g.cur = 1;
            g.fired = 0;
        }
    } else if (pc0 == PC_FAST) {
        const int f = first < V ? first : -1;
        if (f >= 0) {
            fire_fa = true;
            fa_f = f;
        } else {
            if (g.fired) {
                g.pc = PC_BROKEN;
                g.cur = 1;
            } else {
                g.pc = PC_TV1;
                g.cur = 1;
                g.tvr = INF;
                g.tvroot = -1;
            }
            g.fired = 0;
        }
    } else if (pc0 == PC_TV1) {
        // immediate fire: the first scan-base vertex with ratio < 1.02
        const int im_f = first;
        // the window before it: best-so-far tracking (later wins on an
        // equal ratio), early break at ratio < jump, over the scan-base
        // vertices only
        double best = g.tvr, new_tvr = INF;
        int eb_f = V, last_upd = -1;
        for (int v = next_flagged(m, 0, im_f, F_TV); v < im_f;
             v = next_flagged(m, v + 1, im_f, F_TV)) {
            const double rw = m.balr[v];
            if (rw <= best) {
                last_upd = v;
                new_tvr = dmin(new_tvr, rw);
                if (rw < g.jump) {
                    eb_f = v;
                    break;
                }
            }
            best = dmin(best, rw);
        }
        if (last_upd >= 0) {
            g.tvr = dmin(g.tvr, new_tvr);
            g.tvroot = last_upd;
        }
        const bool im_any = im_f < V, eb_any = eb_f < V;
        const bool fire_im = im_any && im_f <= eb_f;
        const bool fire_eb = eb_any && eb_f < im_f;
        const bool end_tv = !im_any && !eb_any;
        const bool end_fire = end_tv && !g.fired && g.tvroot >= 0;
        trig = fire_im || fire_eb || end_fire;
        tv_tgt = fire_im ? im_f : (fire_eb ? eb_f : g.tvroot);
        tv_ret = fire_im ? PC_TV1 : PC_BROKEN;
        tv_retc = fire_im ? im_f + 1 : 1;
        if (fire_im)
            g.fired = 1;
        if (end_tv) {
            if (g.fired) {
                g.pc = PC_BROKEN;
                g.cur = 1;
            } else if (g.tvroot < 0) {
                g.pc = PC_SMALL;
                g.cur = 1;
                g.smr = g.smallr;
                g.sme = -1;
            }
            g.fired = 0;
        }
    } else if (pc0 == PC_SMALL) {
        const int sm_im_f = first;
        double best = g.smr, new_smr = INF;
        int last_um = -1;
        for (int v = next_flagged(m, 0, sm_im_f, F_SMALL); v < sm_im_f;
             v = next_flagged(m, v + 1, sm_im_f, F_SMALL)) {
            const double rw = m.smr_v[v];
            if (rw <= best) {
                last_um = v;
                new_smr = dmin(new_smr, rw);
            }
            best = dmin(best, rw);
        }
        if (last_um >= 0) {
            g.smr = dmin(g.smr, new_smr);
            g.sme = m.sme_v[last_um];
        }
        const bool fire_im = sm_im_f < V;
        const bool end_fire = !fire_im && !g.fired && g.sme >= 0;
        if (fire_im || end_fire) {
            const int rm = fire_im ? m.sme_v[sm_im_f] : g.sme;
            const int rc = clampi(rm, 0, E - 1);
            m.ealive[rc] = 0;
            m.emark[rc] = g.mark;
            g.do_rm = 1;
            ovf = logd(m, g, s, ARM_SMALLEST, rm) || ovf;
        }
        if (fire_im) {
            g.fired = 1;
            g.cur = sm_im_f + 1;
        } else {
            if (end_fire || g.fired) {
                g.pc = PC_BROKEN;
                g.cur = 1;
            } else {            // no candidate left (sme < 0)
                g.pc = PC_DONE;
                g.status = ST_CLEAN;
            }
            g.fired = 0;
        }
    }

    // ----- a decomposition starts (from a FAST or a TV1 fire).  The
    // root's lists are read in place (nothing of the event writes them),
    // up to their lengths: every slot behind is empty, where the plain
    // form adds 0.0 to a sum that is never -0.0 and writes no weight.
    trig = trig || fire_fa;
    if (trig) {
        double* wy = x.wy;
        const int troot = fire_fa ? fa_f : tv_tgt;
        const int rt = clampi(troot, 0, V - 1);
        g.dret = fire_fa ? PC_FAST : tv_ret;
        g.dretc = fire_fa ? fa_f + 1 : tv_retc;
        if (fire_fa)
            g.fired = 1;
        const int* linr = m.lin + rt * dpitch(s);
        const int* loutr = m.lout + rt * dpitch(s);
        const int nin = m.llen[rt], nout = m.llen[V + rt];
        // balance_vertex (scallop.cc:2486-2576)
        const double bw1 = m.inw[rt], bw2 = m.outw[rt];
        const double bww = sqrt(bw1 * bw2);
        const double r1 = bww / (bw1 == 0.0 ? 1.0 : bw1);
        const double r2 = bww / (bw2 == 0.0 ? 1.0 : bw2);
        const double m1 = bal_side(m, g, s, linr, nin, r1, wy);
        const double m2 = bal_side(m, g, s, loutr, nout, r2, wy);
        const int sur_out = clampi(loutr[0], 0, E - 1);
        const int sur_in = clampi(linr[0], 0, E - 1);
        m.ewrt[sur_out] = m.ewrt[sur_out] + (m1 > m2 ? m1 - m2 : 0.0);
        m.ewrt[sur_in] = m.ewrt[sur_in] + (m1 < m2 ? m2 - m1 : 0.0);
        // pairs: the single side against the multi side, in stamp order
        const int side = m.din[rt] == 1 ? 0 : 1;
        const int single_e = side == 0 ? linr[0] : loutr[0];
        const int* multi = side == 0 ? loutr : linr;
        const int nm = side == 0 ? nout : nin;
        int npairs = 0;
        for (int j = 0; j < nm; ++j)
            npairs += multi[j] >= 0;
        const int sc = clampi(single_e, 0, E - 1);
        const double w_single = m.ewrt[sc];
        double md = 0.0;
        for (int j = 0; j < nm; ++j) {
            const double wm = multi[j] >= 0
                ? m.ewrt[clampi(multi[j], 0, E - 1)] : 0.0;
            wy[j] = dmin(w_single, wm);
            md = md + (multi[j] >= 0 ? wy[j] : 0.0);
        }
        m.ewrt[sc] = md;
        for (int j = 0; j < nm; ++j)
            if (multi[j] >= 0)
                m.ewrt[multi[j]] = wy[j];
        // processing order: by multi-side edge id (stable, absent last;
        // the slots behind the list stay absent, with an empty slot's
        // weight)
        for (int j = 0; j < nm; ++j) {
            m.dp_e1[j] = multi[j];
            m.dp_w[j] = wy[j];
        }
        for (int j = 1; j < nm; ++j) {
            const int e = m.dp_e1[j];
            const int key = e >= 0 ? e : BIGI;
            const double w = m.dp_w[j];
            int i = j - 1;
            while (i >= 0 && (m.dp_e1[i] >= 0 ? m.dp_e1[i] : BIGI) > key) {
                m.dp_e1[i + 1] = m.dp_e1[i];
                m.dp_w[i + 1] = m.dp_w[i];
                --i;
            }
            m.dp_e1[i + 1] = e;
            m.dp_w[i + 1] = w;
        }
        for (int j = 0; j < nm; ++j) {
            const int ms = m.dp_e1[j];
            m.dp_e1[j] = ms >= 0 ? (side == 0 ? single_e : ms) : -1;
            m.dp_e2[j] = ms >= 0 ? (side == 0 ? ms : single_e) : -1;
        }
        const double w_absent = dmin(w_single, 0.0);
        for (int j = nm; j < DMAX; ++j) {
            m.dp_e1[j] = -1;
            m.dp_e2[j] = -1;
            m.dp_w[j] = w_absent;
        }
        g.dp_n = npairs;
        g.dp_k = 0;
        g.dp_ms = npairs;
        g.dside = side;
        g.droot = troot;
        g.pc = PC_DECOMP;
        ovf = logd(m, g, s, ARM_TRIVIAL, troot) || ovf;
        ovf = ovf || npairs > DMAX || g.degover;
    }

    // ----- one pair of the pending decomposition
    if (pc0 == PC_DECOMP) {
        const int kc = clampi(g.dp_k, 0, DMAX - 1);
        const int pe1 = m.dp_e1[kc], pe2 = m.dp_e2[kc];
        const double pww = m.dp_w[kc];
        const bool do_pair = g.dp_k < g.dp_n;
        const bool ovf_e = do_pair && g.nedges + 3 > E;
        const bool ok_pair = do_pair && !ovf_e;
        ovf = ovf || ovf_e;
        const int x1 = split(m, g, s, clampi(pe1, 0, E - 1), pww, ok_pair);
        const int y1 = split(m, g, s, clampi(pe2, 0, E - 1), pww, ok_pair);
        const int x1c = clampi(x1, 0, E - 1), y1c = clampi(y1, 0, E - 1);
        const int newe = g.nedges;
        const int rc = clampi(g.droot, 0, V - 1);
        if (ok_pair) {
            // merge x1, y1 into a new edge
            const int ns = clampi(g.nedges, 0, E - 1);
            const double wx0 = m.ewrt[x1c], wy0 = m.ewrt[y1c];
            m.esrc[ns] = m.esrc[x1c];
            m.edst[ns] = m.edst[y1c];
            m.ewrt[ns] = wx0 * 0.5 + wy0 * 0.5;
            const int zx = m.estr[x1c], zy = m.estr[y1c];
            m.estr[ns] = zy != 0 ? zy : (zx != 0 ? zx : 0);
            m.esin[ns] = g.nstamp;
            m.esout[ns] = g.nstamp;
            m.ealive[ns] = 1;
            m.ealive[x1c] = 0;
            m.ealive[y1c] = 0;
            g.nedges += 1;
            g.nstamp += 1;
            // the root is erased once isolated: the post pass counts
            g.root = rc;
            g.do_pair = 1;
            g.hx = pe1;
            g.hy = pe2;
            g.he = newe;
            g.do_s1 = (g.dside == 0 ? g.dp_ms : 1) == 1;
            g.hx1 = pe1;
            g.do_s2 = (g.dside == 0 ? 1 : g.dp_ms) == 1;
            g.hx2 = pe2;
        }
        g.dp_k += do_pair;
        if (g.dp_k >= g.dp_n) {
            // all pairs done: the pair edges (the first dp_n slots) leave
            // the hyper lists, the root is erased, the arm that fired
            // resumes
            for (int j = 0; j < g.dp_n && j < DMAX; ++j) {
                if (m.dp_e1[j] >= 0)
                    m.emark[m.dp_e1[j]] = g.mark;
                if (m.dp_e2[j] >= 0)
                    m.emark[m.dp_e2[j]] = g.mark;
            }
            g.do_rm = 1;
            m.nz[rc] = 0;
            g.root = -1;
            g.pc = g.dret;
            g.cur = g.dretc;
        }
    }

    if (ovf) {
        g.pc = PC_DONE;
        g.status = ST_OVERFLOW;
    }
    g.stale = g.stale || g.do_pair || g.do_s1 || g.do_s2 || g.do_rm;
    g.degover = 0;
    gs = g;
}

// The event's passes over the edges, on every thread: the broken vertex's
// edges marked and killed, and the root of a merged pair erased when no
// live edge touches it.  Ends with a barrier.
LADDER_FN void post(Smem& m, Scal& g, const Shape& s, Blk& b) {
    const int kill = g.kill, root = g.root;
    bool touched = false;
    for (int e = b.tid; e < s.E; e += b.nt) {
        const bool live = m.ealive[e];
        if (kill >= 0 && live && (m.edst[e] == kill || m.esrc[e] == kill)) {
            m.emark[e] = g.mark;
            m.ealive[e] = 0;
        }
        if (root >= 0)
            touched = touched
                || (live && (m.edst[e] == root || m.esrc[e] == root));
    }
    if (root >= 0) {
        if (!blk_or(b, touched) && b.tid == 0)
            m.nz[root] = 0;
    } else {
        b.sync();
    }
}

// ------------------------------------------------------------- the tables

// Degrees and strand degrees of this iteration (the tables are clear:
// load_graph, apply_entries): a live edge counts in the degrees of its
// endpoints that are vertices.  With buckets, each also lands in its
// vertex's bucket of in-edges (out-edges) at the slot its degree count
// gave it, where that slot is below DMAX.  One barrier.
LADDER_FN void build_degrees(Smem& m, const Shape& s, const Blk& b,
                             bool buckets) {
    const int V = s.V, P = dpitch(s);
    for (int e = b.tid; e < s.E; e += b.nt) {
        if (!m.ealive[e])
            continue;
        const int z = m.estr[e], d = m.edst[e], r = m.esrc[e];
        if (d >= 0 && d < V) {
            const int k = atomic_add(&m.din[d], 1);
            if (buckets && k < s.DMAX)
                m.bucket[d * P + k] = e;
            if (z >= 0 && z < 3)
                atomic_add(&m.sin3[3 * d + z], 1);
        }
        if (r >= 0 && r < V) {
            const int k = atomic_add(&m.dout[r], 1);
            if (buckets && k < s.DMAX)
                m.bucket[(V + r) * P + k] = e;
            if (z >= 0 && z < 3)
                atomic_add(&m.sout3[3 * r + z], 1);
        }
    }
    b.sync();
}

// The adjacency lists of this iteration, after build_degrees with
// buckets: each live edge's rank in its vertex's list, the number of live
// edges into (out of) the same vertex with a smaller stamp, counted inside
// the vertex's bucket, which holds all of them where the degree is at most
// DMAX.  Ranks past DMAX share the last slot, where the larger edge id
// stays; llen takes each list's length (its last slot taken + 1).  A
// vertex of a larger degree, and an endpoint that is no vertex (never on
// the states the ladder is given; it lists at the nearest vertex, as the
// plain form's clamped scatter does), rank by a count over all edges.
// One barrier.
LADDER_FN void build_lists(Smem& m, const Shape& s, const Blk& b) {
    const int V = s.V, E = s.E, DMAX = s.DMAX, P = dpitch(s);
    for (int e = b.tid; e < E; e += b.nt) {
        if (!m.ealive[e])
            continue;
        const int d = m.edst[e], sr = m.esrc[e];
        const int ti = m.esin[e], to = m.esout[e];
        int ri = 0, ro = 0;
        if (d >= 0 && d < V && m.din[d] <= DMAX) {
            const int* bk = m.bucket + d * P;
            for (int i = 0; i < m.din[d]; ++i)
                ri += m.esin[bk[i]] < ti;
        } else {
            for (int f = 0; f < E; ++f)
                ri += m.ealive[f] && m.edst[f] == d && m.esin[f] < ti;
        }
        if (sr >= 0 && sr < V && m.dout[sr] <= DMAX) {
            const int* bk = m.bucket + (V + sr) * P;
            for (int i = 0; i < m.dout[sr]; ++i)
                ro += m.esout[bk[i]] < to;
        } else {
            for (int f = 0; f < E; ++f)
                ro += m.ealive[f] && m.esrc[f] == sr && m.esout[f] < to;
        }
        const int vi = clampi(d, 0, V - 1), vo = clampi(sr, 0, V - 1);
        const int ji = ri < DMAX ? ri : DMAX - 1;
        const int jo = ro < DMAX ? ro : DMAX - 1;
        atomic_max(&m.lin[vi * P + ji], e);
        atomic_max(&m.lout[vo * P + jo], e);
        atomic_max(&m.llen[vi], ji + 1);
        atomic_max(&m.llen[V + vo], jo + 1);
    }
    b.sync();
}

// Ordered sum along a list of length n, one add at a time in list order,
// and its last-min-wins smallest edge (compute_smallest_{in,out}_edge,
// scallop.cc:2967-3007) in the same pass: the running minimum changes
// only on a smaller weight, and an equal one moves the last index.  The
// empty slots behind the list change nothing: the plain form adds 0.0
// there to a sum that is never -0.0.
LADDER_FN void list_stats(const Smem& m, const Shape& s, const int* lst,
                          int n, double* sum, int* sm_e, double* sm_w) {
    double acc = 0.0, mn = INF;
    int last = -1;
    for (int j = 0; j < n; ++j) {
        const int e = lst[j];
        const bool ok = e >= 0;
        const double w = m.ewrt[clampi(e, 0, s.E - 1)];
        acc = acc + (ok ? w : 0.0);
        if (ok && w < mn) {
            mn = w;
            last = j;
        } else if (ok && w == mn) {
            last = j;
        }
    }
    *sum = acc;
    *sm_e = last >= 0 ? lst[last] : -1;
    *sm_w = mn;
}

// Each adjacency list's statistics on a thread of its own (the in-lists on
// threads 0 to V - 1, the out-lists behind them), and g.degover set where
// a degree exceeds DMAX.
LADDER_FN void list_tables(Smem& m, Scal& g, const Shape& s,
                           const Blk& b) {
    for (int i = b.tid; i < 2 * s.V; i += b.nt) {
        const bool out = i >= s.V;
        const int v = out ? i - s.V : i;
        const int* lst = (out ? m.lout : m.lin) + v * dpitch(s);
        if (out)
            list_stats(m, s, lst, m.llen[i], &m.outw[v], &m.sm_out_e[v],
                       &m.sm_out_w[v]);
        else
            list_stats(m, s, lst, m.llen[i], &m.inw[v], &m.sm_in_e[v],
                       &m.sm_in_w[v]);
        if (m.deg[i] > s.DMAX)
            atomic_max(&g.degover, 1);
    }
}

// Whether vertex v is a broken-vertex candidate (the broken arm's only
// table: the degrees).
LADDER_FN bool broken_flag(Smem& m, const Scal& g, int v) {
    const bool active = v >= 1 && v < g.nv - 1 && m.nz[v];
    const bool f = active && (m.din[v] == 0 || m.dout[v] == 0);
    m.flag[v] = f ? F_BROKEN : 0;
    return f;
}

// Vertex v's ratio and the candidate flags of the arm that runs, the hyper
// queries only where they decide (*hq: their clock cycles, PROF); returns
// whether v is the arm's immediate candidate (the one the event fires at
// first).
LADDER_FN bool vertex_flags(Smem& m, const Scal& g, const Shape& s, int v,
                            int pc0, int cur, unsigned long long* hq) {
    const int V = s.V, E = s.E, DMAX = s.DMAX;
    const double w1 = m.inw[v], w2 = m.outw[v];
    const double balr = w1 >= w2 ? w1 / (w2 == 0.0 ? 1.0 : w2)
                                 : w2 / (w1 == 0.0 ? 1.0 : w1);
    m.balr[v] = balr;
    const int di = m.din[v], dq = m.dout[v];
    const bool active = v >= 1 && v < g.nv - 1 && m.nz[v];
    const int hi_c = clampi(m.lin[v * dpitch(s)], 0, E - 1);
    const int ho_c = clampi(m.lout[v * dpitch(s)], 0, E - 1);
    const int outdeg_src = m.dout[clampi(m.esrc[hi_c], 0, V - 1)];
    const int indeg_dst = m.din[clampi(m.edst[ho_c], 0, V - 1)];
    const bool cls1_nofast = (di == 1 && outdeg_src == 1)
        || (dq == 1 && indeg_dst == 1);
    const bool mixed = m.sin3[3 * v + 1] + m.sout3[3 * v + 1] >= 1
        && m.sin3[3 * v + 2] + m.sout3[3 * v + 2] >= 1;
    const bool one_sided = (di == 1 || dq == 1) && di > 0 && dq > 0;
    const bool base_triv = active && di > 0 && dq > 0
        && !(di >= 2 && dq >= 2) && !mixed && one_sided;
    const bool ge_cur = v >= cur;
    uint8_t f = 0;
    bool first = false;
    if (pc0 == PC_BROKEN && active && (di == 0 || dq == 0)) {
        f |= F_BROKEN;
        first = true;
    }
    if (pc0 == PC_FAST && base_triv && cls1_nofast && balr < g.jump
        && ge_cur) {
        f |= F_FAST;
        first = true;
    }
    if (pc0 == PC_TV1 && base_triv && ge_cur) {
        // the dominate queries only where they decide
        const unsigned long long t0 = LADDER_CLOCK();
        const bool cls1_fast = cls1_nofast
            || (di == 1 && dominates(m, s, hi_c, true))
            || (dq == 1 && dominates(m, s, ho_c, false));
        *hq += LADDER_CLOCK() - t0;
        if (cls1_fast) {
            f |= F_TV;
            first = balr < 1.02;
        }
    }
    if (pc0 == PC_SMALL) {
        const bool in_ok = m.sm_in_e[v] >= 0, out_ok = m.sm_out_e[v] >= 0;
        const double r_in = in_ok ? m.sm_in_w[v] / w1 : 0.0;
        const double r_out = out_ok ? m.sm_out_w[v] / w2 : 0.0;
        const bool use_in = r_in < r_out;
        const int sm_e = in_ok && out_ok
            ? (use_in ? m.sm_in_e[v] : m.sm_out_e[v]) : -1;
        const double smr = in_ok && out_ok ? (use_in ? r_in : r_out) : 0.0;
        m.sme_v[v] = sm_e;
        m.smr_v[v] = smr;
        const int smec = clampi(sm_e, 0, E - 1);
        const int es = m.esrc[smec], et = m.edst[smec];
        const bool deg_ok = m.dout[clampi(es, 0, V - 1)] > 1
            && m.din[clampi(et, 0, V - 1)] > 1;
        // the extend queries only where they decide
        if (active && di > 1 && dq > 1 && sm_e >= 0 && deg_ok && ge_cur) {
            bool le, re;
            const unsigned long long t0 = LADDER_CLOCK();
            extends(m, s, smec, &le, &re);
            *hq += LADDER_CLOCK() - t0;
            const bool at_t = et == v, at_s = es == v;
            const bool ext_ok = !(le && re) && !(at_t && re)
                && !(at_s && le);
            const int z = m.estr[smec];
            const int zc = clampi(z, 0, 2);
            const bool str_ok =
                !(at_s && z >= 1
                  && m.sin3[3 * v] + m.sin3[3 * v + zc] <= 1)
                && !(at_t && z >= 1
                     && m.sout3[3 * v] + m.sout3[3 * v + zc] <= 1);
            if (ext_ok && str_ok) {
                f |= F_SMALL;
                first = smr < 0.01;
            }
        }
    }
    m.flag[v] = f;
    return first;
}

// ------------------------------------------------------------ one graph

// Graph b's state from the inputs, by the threads of its block, and the
// tables clear.
LADDER_FN void load_graph(Smem& m, Scal& g, const Shape& s, const In& in,
                          int gb, const Blk& b) {
    const int V = s.V, E = s.E, HL = s.H * s.L;
    const long long* st = in.st;
    for (int e = b.tid; e < E; e += b.nt) {
        m.esrc[e] = in.esrc[gb * st[0] + e];
        m.edst[e] = in.edst[gb * st[1] + e];
        m.ewrt[e] = in.ewrt[gb * st[2] + e];
        m.estr[e] = in.estr[gb * st[3] + e];
        m.esin[e] = in.esin[gb * st[4] + e];
        m.esout[e] = in.esout[gb * st[5] + e];
        m.ealive[e] = in.ealive[gb * st[6] + e] != 0;
        m.occ_cnt[e] = 0;
        m.emark[e] = -1;
    }
    for (int v = b.tid; v < (int)round4(V); v += b.nt) {
        if (v < V)
            m.nz[v] = in.nz[gb * st[9] + v] != 0;
        m.flag[v] = 0;
    }
    for (int i = b.tid; i < HL; i += b.nt) {
        const int h = i / s.L;
        m.hedge[h * lpitch(s) + i - h * s.L] = in.hedge[gb * st[10] + i];
    }
    for (int h = b.tid; h < s.H; h += b.nt)
        m.hlen[h] = in.hlen[gb * st[11] + h];
    for (int i = b.tid; i < s.DLOG; i += b.nt) {
        m.larm[i] = 0;
        m.ltgt[i] = 0;
    }
    for (int j = b.tid; j < s.DMAX; j += b.nt) {
        m.dp_e1[j] = -1;
        m.dp_e2[j] = -1;
        m.dp_w[j] = 0.0;
    }
    for (int i = b.tid; i < V * dpitch(s); i += b.nt) {
        m.lin[i] = -1;
        m.lout[i] = -1;
    }
    for (int i = b.tid; i < 3 * V; i += b.nt) {
        m.sin3[i] = 0;
        m.sout3[i] = 0;
    }
    for (int i = b.tid; i < 2 * V; i += b.nt) {
        m.deg[i] = 0;
        m.llen[i] = 0;
    }
    if (b.tid == 0) {
        g.nv = in.nv[gb * st[12]];
        g.pc = g.nv > 0 ? PC_BROKEN : PC_DONE;
        g.status = g.nv > 0 ? ST_RUN : ST_CLEAN;
        g.cur = 1;
        g.fired = 0;
        g.tvr = INF;
        g.tvroot = -1;
        g.jump = in.jump[gb * st[13]];
        g.smallr = in.smallr[gb * st[14]];
        g.guard = in.guard[gb * st[15]];
        g.smin = in.smin[gb * st[16]];
        g.smr = g.smallr;
        g.sme = -1;
        g.droot = -1;
        g.dp_n = g.dp_k = g.dp_ms = g.dside = g.dret = 0;
        g.dretc = 1;
        g.ndec = 0;
        g.nedges = in.nedges[gb * st[7]];
        g.nstamp = in.nstamp[gb * st[8]];
        g.it = 0;
        g.stale = 1;
        g.degover = 0;
    }
}

// The events of the loaded graph, to PC_DONE or maxiter.  Every thread of
// the block calls it: each decision every thread reads (the loop's test,
// which passes run) is read from shared state after a barrier, so all
// threads take the same passes and leave together.  An event builds only
// the tables its arm reads: a pair of a decomposition none, the broken
// arm the degrees, the other arms the lists and their statistics too.
// PROF: thread 0 reads the clock at the barriers and adds each pass's
// cycles to pf (the hyper queries are the longest any thread spent in
// them, taken out of P_FLAGS).
template <bool PROF>
LADDER_FN void run_graph(Smem& m, Scal& g, const Shape& s, Scratch& x,
                         int maxiter, Blk& b, Prof* pf) {
    b.sync();
    while (g.pc != PC_DONE && g.it < maxiter) {
        const int pc0 = g.pc, cur = g.cur;
        const int level = pc0 == PC_DECOMP ? 0 : (pc0 == PC_BROKEN ? 1 : 2);
        const bool query = (pc0 == PC_TV1 || pc0 == PC_SMALL) && g.stale;
        unsigned long long t[8] = {0, 0, 0, 0, 0, 0, 0, 0}, hq = 0, hq_v = 0;
        if (PROF && b.tid == 0) {
            pf->hq = 0;
            t[0] = LADDER_CLOCK();
        }
        if (level >= 1)
            build_degrees(m, s, b, level >= 2);
        if (level >= 2)
            build_lists(m, s, b);
        if (PROF && b.tid == 0)
            t[1] = LADDER_CLOCK();
        int first = s.V;
        if (level == 1) {
            for (int v = b.tid; v < s.V; v += b.nt)
                if (broken_flag(m, g, v) && v < first)
                    first = v;
            first = blk_min(b, first);
        } else if (level == 2) {
            list_tables(m, g, s, b);
            if (query) {
                // the occurrence index, rebuilt where the arm that runs
                // asks the hyper lists and they changed since the last
                // build
                occ_count(m, s, b);
                b.sync();
                if (PROF && b.tid == 0)
                    t[2] = LADDER_CLOCK();
                occ_scatter(m, s, b);
                if (PROF && b.tid == 0) {
                    hq = LADDER_CLOCK() - t[2];
                    t[2] += hq;
                }
            } else {
                b.sync();
                if (PROF && b.tid == 0)
                    t[2] = LADDER_CLOCK();
            }
            for (int v = b.tid; v < s.V; v += b.nt)
                if (vertex_flags(m, g, s, v, pc0, cur, &hq_v) && v < first)
                    first = v;
            if (PROF)
                atomic_max(&pf->hq, hq_v);
            first = blk_min(b, first);
        } else {
            b.sync();       // every thread has read pc before it changes
        }
        if (PROF && b.tid == 0) {
            t[3] = LADDER_CLOCK();
            if (level < 2)
                t[2] = t[1];
        }
        if (b.tid == 0) {
            if (query)
                g.stale = 0;
            event(m, g, s, x, first);
            g.it += 1;
        }
        b.sync();
        if (PROF && b.tid == 0)
            t[4] = LADDER_CLOCK();
        if (g.kill >= 0 || g.root >= 0)
            post(m, g, s, b);
        if (PROF && b.tid == 0)
            t[5] = LADDER_CLOCK();
        apply_pair(m, g, s, b);
        if (PROF && b.tid == 0)
            t[6] = LADDER_CLOCK();
        apply_entries(m, g, s, b, level);
        b.sync();
        if (PROF && b.tid == 0) {
            t[7] = LADDER_CLOCK();
            pf->acc[P_BUILD * NPC + pc0] += t[1] - t[0];
            pf->acc[P_LISTS * NPC + pc0] += t[2] - t[1] - hq;
            pf->acc[P_FLAGS * NPC + pc0] += t[3] - t[2] - pf->hq;
            pf->acc[P_HYPER * NPC + pc0] += hq + pf->hq;
            pf->acc[P_EVENT * NPC + pc0] += t[4] - t[3];
            pf->acc[P_POST * NPC + pc0] += t[5] - t[4];
            pf->acc[P_PAIR * NPC + pc0] += t[6] - t[5];
            pf->acc[P_APPLY * NPC + pc0] += t[7] - t[6];
            pf->acc[NPASS * NPC + pc0] += 1;
        }
    }
}

// Graph b's outputs (those whose pointer is not null) and its event count.
LADDER_FN void store_graph(const Smem& m, const Scal& g, const Shape& s,
                           const Out& out, int gb, const Blk& b) {
    const int V = s.V, E = s.E, HL = s.H * s.L;
    const size_t b_ = gb;
    if (b.tid == 0) {
        if (out.ndec)
            out.ndec[b_] = g.ndec;
        if (out.status)
            out.status[b_] = g.status == ST_RUN ? ST_OVERFLOW : g.status;
        if (out.nedges)
            out.nedges[b_] = g.nedges;
        if (out.events)
            out.events[b_] = g.it;
    }
    for (int e = b.tid; e < E; e += b.nt) {
        const size_t i = b_ * E + e;
        if (out.ewrt)
            out.ewrt[i] = m.ewrt[e];
        if (out.ealive)
            out.ealive[i] = m.ealive[e];
        if (out.esrc)
            out.esrc[i] = m.esrc[e];
        if (out.edst)
            out.edst[i] = m.edst[e];
        if (out.estr)
            out.estr[i] = m.estr[e];
    }
    for (int i = b.tid; i < s.DLOG; i += b.nt) {
        if (out.larm)
            out.larm[b_ * s.DLOG + i] = m.larm[i];
        if (out.ltgt)
            out.ltgt[b_ * s.DLOG + i] = m.ltgt[i];
    }
    if (out.hedge)
        for (int i = b.tid; i < HL; i += b.nt) {
            const int h = i / s.L;
            out.hedge[b_ * HL + i] = m.hedge[h * lpitch(s) + i - h * s.L];
        }
    if (out.hlen)
        for (int h = b.tid; h < s.H; h += b.nt)
            out.hlen[b_ * s.H + h] = m.hlen[h];
    if (out.nz)
        for (int v = b.tid; v < V; v += b.nt)
            out.nz[b_ * V + v] = m.nz[v];
}

// Whether the kernel takes this shape (the event's scratch lists hold
// MAX_DMAX entries).
LADDER_HD bool shape_ok(const Shape& s) {
    return s.V >= 1 && s.E >= 1 && s.H >= 1 && s.L >= 1 && s.DMAX >= 1
        && s.DMAX <= MAX_DMAX && s.DLOG >= 1;
}

}  // namespace ladder
