// The per-graph machine of the resolution-ladder kernel (ladder.cu): one
// graph's state in shared memory, its per-event tables and its events.
//
// nvcc compiles it for the card, where a block of `nt` threads shares the
// work of the tables and thread 0 applies each event.  A host compiler
// compiles the same code for one thread (ladder_host.cpp), where the
// barriers are no-ops and the atomics plain: the CPU tests hold that build
// against the plain PyTorch form, so the transcription is tested where no
// card is.  Both builds must keep every f64 product and sum a rounding of
// its own: nvcc -fmad=false, g++ -ffp-contract=off.

#pragma once

#include <math.h>
#include <stdint.h>
#include <stddef.h>

#ifdef __CUDACC__
#define LADDER_HD __host__ __device__ inline
#define LADDER_FN __device__ inline
#define LADDER_SYNC() __syncthreads()
#define LADDER_ATOMIC_MAX(p, v) atomicMax((p), (v))
#else
#define LADDER_HD inline
#define LADDER_FN inline
#define LADDER_SYNC() ((void)0)
#define LADDER_ATOMIC_MAX(p, v) (*(p) = *(p) > (v) ? *(p) : (v))
#endif

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
// the largest DMAX: the event's scratch lists (Scratch) hold this many
constexpr int MAX_DMAX = 256;

// per-vertex candidate flags of one event
constexpr uint8_t F_BROKEN = 1;     // broken-vertex candidate
constexpr uint8_t F_FAST = 2;       // fast trivial candidate
constexpr uint8_t F_TV = 4;         // trivial-vertex scan base
constexpr uint8_t F_SMALL = 8;      // smallest-edge candidate

struct Shape {
    int V, E, H, L, DMAX, DLOG;
};

// the 17 inputs, [B, ...] row-major
struct In {
    const int *esrc, *edst;
    const double* ewrt;
    const int *estr, *esin, *esout;
    const uint8_t* ealive;
    const int *nedges, *nstamp;
    const uint8_t* nz;
    const int *hedge, *hlen, *nv;
    const double *jump, *smallr, *guard, *smin;
};

// the 13 outputs and the per-graph event counts, [B, ...] row-major
struct Out {
    int *larm, *ltgt, *ndec, *status;
    double* ewrt;
    uint8_t* ealive;
    int *esrc, *edst, *estr, *nedges, *hedge, *hlen;
    uint8_t* nz;
    int* events;
};

// the loop's scalar state, the graph's parameters, and the hyper-list
// updates the event leaves for the whole block (apply_hyper): replace the
// pair [hx, hy] by he, then the single hx1 and the single hx2 by he, then
// remove the edges marked in emask, each where its flag is set
struct Scal {
    int pc, cur, fired, tvroot, sme, droot, dp_n, dp_k, dp_ms, dside, dret,
        dretc, ndec, status, nedges, nstamp, it, nv;
    int do_pair, do_s1, do_s2, do_rm, hx, hy, hx1, hx2, he;
    double tvr, smr, jump, smallr, guard, smin;
};

// an event's lists of the root and weights being rewritten (thread 0)
struct Scratch {
    double wy[MAX_DMAX];
    int linr[MAX_DMAX], loutr[MAX_DMAX];
};

// the graph's arrays in (dynamic shared) memory
struct Smem {
    double *ewrt, *inw, *outw, *sm_in_w, *sm_out_w, *balr, *smr_v, *dp_w;
    int *esrc, *edst, *estr, *esin, *esout, *hedge, *hlen, *larm, *ltgt;
    int *lin, *lout, *din, *dout, *sm_in_e, *sm_out_e, *sin3, *sout3;
    int *sme_v, *dp_e1, *dp_e2;
    uint8_t *ealive, *nz, *flag, *emask;
};

// Smem's arrays laid out from base (f64 first, then i32, then u8); returns
// the bytes they take.  base == nullptr computes the size only.
LADDER_HD size_t carve(char* base, const Shape& s, Smem* m) {
    size_t off = 0;
    const size_t V = s.V, E = s.E, HL = (size_t)s.H * s.L, D = s.DMAX;
    double* d[8];
    const size_t dn[8] = {E, V, V, V, V, V, V, D};
    for (int i = 0; i < 8; ++i) {
        d[i] = base ? (double*)(base + off) : nullptr;
        off += dn[i] * sizeof(double);
    }
    int* q[20];
    const size_t qn[20] = {E, E, E, E, E, HL, (size_t)s.H, (size_t)s.DLOG,
                           (size_t)s.DLOG, V * D, V * D, V, V, V, V, 3 * V,
                           3 * V, V, D, D};
    for (int i = 0; i < 20; ++i) {
        q[i] = base ? (int*)(base + off) : nullptr;
        off += qn[i] * sizeof(int);
    }
    uint8_t* u[4];
    const size_t un[4] = {E, V, V, E};
    for (int i = 0; i < 4; ++i) {
        u[i] = base ? (uint8_t*)(base + off) : nullptr;
        off += un[i];
    }
    if (m) {
        m->ewrt = d[0]; m->inw = d[1]; m->outw = d[2]; m->sm_in_w = d[3];
        m->sm_out_w = d[4]; m->balr = d[5]; m->smr_v = d[6]; m->dp_w = d[7];
        m->esrc = q[0]; m->edst = q[1]; m->estr = q[2]; m->esin = q[3];
        m->esout = q[4]; m->hedge = q[5]; m->hlen = q[6]; m->larm = q[7];
        m->ltgt = q[8]; m->lin = q[9]; m->lout = q[10]; m->din = q[11];
        m->dout = q[12]; m->sm_in_e = q[13]; m->sm_out_e = q[14];
        m->sin3 = q[15]; m->sout3 = q[16]; m->sme_v = q[17];
        m->dp_e1 = q[18]; m->dp_e2 = q[19];
        m->ealive = u[0]; m->nz = u[1]; m->flag = u[2]; m->emask = u[3];
    }
    return off;
}

LADDER_FN int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

LADDER_FN int imax(int a, int b) { return a > b ? a : b; }

// torch.minimum on values that are not NaN
LADDER_FN double dmin(double a, double b) { return b < a ? b : a; }

// ------------------------------------------------------ hyper-list queries

// Entry l of a hyper row read left to right, or (right) in the reverse of
// its valid prefix of length ln.
LADDER_FN int hat(const int* row, int ln, int l, bool right) {
    return right ? row[ln - 1 - l] : row[l];
}

// Whether some occurrence of ec that is not the start of a run (an "x2")
// is followed by n1, and by n2 too unless n2 == -1.
LADDER_FN bool has_x2(const Smem& m, const Shape& s, int ec, bool right,
                      int n1, int n2) {
    for (int h = 0; h < s.H; ++h) {
        const int ln = clampi(m.hlen[h], 0, s.L);
        const int* row = m.hedge + h * s.L;
        for (int l = 1; l + 1 < ln; ++l) {
            if (hat(row, ln, l, right) != ec
                || hat(row, ln, l - 1, right) == -1)
                continue;
            if (hat(row, ln, l + 1, right) != n1)
                continue;       // also skips -1: n1 != -1
            const int n2x = l + 2 < ln ? hat(row, ln, l + 2, right) : -1;
            if (n2 == -1 || n2x == n2)
                return true;
        }
    }
    return false;
}

// left_dominate (right = false) / right_dominate (right = true) of edge ec
// (hyper_set.cc:1003-1082; ops/ladder_kernel.py::dominates): every
// occurrence of ec that starts a run and has a successor n1 (then n2, or
// -1) must be matched by a non-starting occurrence followed by n1, and by
// n2 when n2 != -1.
LADDER_FN bool dominates(const Smem& m, const Shape& s, int ec, bool right) {
    for (int h = 0; h < s.H; ++h) {
        const int ln = clampi(m.hlen[h], 0, s.L);
        const int* row = m.hedge + h * s.L;
        for (int l = 0; l + 1 < ln; ++l) {
            if (hat(row, ln, l, right) != ec)
                continue;
            const int n1 = hat(row, ln, l + 1, right);
            if (n1 == -1)
                continue;
            if (l > 0 && hat(row, ln, l - 1, right) != -1)
                continue;       // not a start: an x2 entry
            const int n2 = l + 2 < ln ? hat(row, ln, l + 2, right) : -1;
            if (!has_x2(m, s, ec, right, n1, n2))
                return false;
        }
    }
    return true;
}

// (left_extend, right_extend) of edge ec: some occurrence has a
// predecessor / a successor that is not -1.
LADDER_FN void extends(const Smem& m, const Shape& s, int ec, bool* le,
                       bool* re) {
    bool l_ = false, r_ = false;
    for (int h = 0; h < s.H; ++h) {
        const int ln = clampi(m.hlen[h], 0, s.L);
        const int* row = m.hedge + h * s.L;
        for (int l = 0; l < ln; ++l) {
            if (row[l] != ec)
                continue;
            l_ = l_ || (l > 0 && row[l - 1] != -1);
            r_ = r_ || (l + 1 < ln && row[l + 1] != -1);
        }
    }
    *le = l_;
    *re = r_;
}

// ---------------------------------------------------- hyper-list updates

// Row h: every occurrence of an edge marked in emask becomes -1.
LADDER_FN void hs_remove_mask(Smem& m, const Shape& s, int h) {
    int* row = m.hedge + h * s.L;
    const int n = m.hlen[h];
    for (int l = 0; l < s.L && l < n; ++l)
        if (row[l] >= 0 && m.emask[row[l] < s.E ? row[l] : s.E - 1])
            row[l] = -1;
}

// Row h, replace_list([x], e): every occurrence of x becomes e.
LADDER_FN void hs_replace_single(Smem& m, const Shape& s, int h, int x,
                                 int e) {
    int* row = m.hedge + h * s.L;
    const int n = m.hlen[h];
    for (int l = 0; l < s.L && l < n; ++l)
        if (row[l] == x)
            row[l] = e;
}

// Row h, replace_list([x, y], e): each [x, y] (matched on the row as it
// was) becomes [e]; the row is compacted and padded with -1 behind its
// new length.  In place: step l reads entries l and l + 1 before it writes
// entry k <= l.
LADDER_FN void hs_replace_pair(Smem& m, const Shape& s, int h, int x, int y,
                               int e) {
    int* row = m.hedge + h * s.L;
    const int n = m.hlen[h];
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

// The event's hyper-list updates, in the plain form's order, a row a
// thread: rows are independent, and nothing of the event reads the hyper
// lists after it updates them.
LADDER_FN void apply_hyper(Smem& m, const Scal& g, const Shape& s, int tid,
                           int nt) {
    for (int h = tid; h < s.H; h += nt) {
        if (g.do_pair)
            hs_replace_pair(m, s, h, g.hx, g.hy, g.he);
        if (g.do_s1)
            hs_replace_single(m, s, h, g.hx1, g.he);
        if (g.do_s2)
            hs_replace_single(m, s, h, g.hx2, g.he);
        if (g.do_rm)
            hs_remove_mask(m, s, h);
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

// balance_vertex's rescale of one side of the root: returns the side's
// surplus m (an ordered sum along the list); the weights are rewritten.
LADDER_FN double bal_side(Smem& m, const Scal& g, const Shape& s,
                          const int* lst, double rr, double* wy) {
    double acc = 0.0;
    for (int j = 0; j < s.DMAX; ++j) {
        const bool ok = lst[j] >= 0;
        const double w = m.ewrt[clampi(lst[j], 0, s.E - 1)] * rr;
        const bool low = w < g.guard;
        acc = acc + ((ok && low) ? g.guard - w : 0.0);
        wy[j] = low ? g.guard : w;
    }
    for (int j = 0; j < s.DMAX; ++j)
        if (lst[j] >= 0)
            m.ewrt[lst[j]] = wy[j];
    return acc;
}

// One event of the graph (one thread), on the tables of this iteration.
LADDER_FN void event(Smem& m, Scal& g, const Shape& s, Scratch& x) {
    const int V = s.V, E = s.E, DMAX = s.DMAX;
    const int pc0 = g.pc;
    g.do_pair = g.do_s1 = g.do_s2 = g.do_rm = 0;
    bool ovf = false;
    bool trig = false;
    bool fire_fa = false;
    int fa_f = 0, tv_tgt = 0, tv_ret = 0, tv_retc = 0;

    if (pc0 == PC_BROKEN) {
        int bx = -1;
        for (int v = 0; v < V && bx < 0; ++v)
            if (m.flag[v] & F_BROKEN)
                bx = v;
        if (bx >= 0) {
            for (int e = 0; e < E; ++e)
                m.emask[e] = m.ealive[e]
                    && (m.edst[e] == bx || m.esrc[e] == bx);
            for (int e = 0; e < E; ++e)
                if (m.emask[e])
                    m.ealive[e] = 0;
            g.do_rm = 1;
            m.nz[bx] = 0;
            ovf = logd(m, g, s, ARM_BROKEN, bx) || ovf;
        } else {
            g.pc = PC_FAST;
            g.cur = 1;
            g.fired = 0;
        }
    } else if (pc0 == PC_FAST) {
        int f = -1;
        for (int v = 0; v < V && f < 0; ++v)
            if (m.flag[v] & F_FAST)
                f = v;
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
        int im_f = V;
        for (int v = 0; v < V; ++v)
            if ((m.flag[v] & F_TV) && m.balr[v] < 1.02) {
                im_f = v;
                break;
            }
        // the window before it: best-so-far tracking (later wins on an
        // equal ratio), early break at ratio < jump
        double best = g.tvr, new_tvr = INF;
        int eb_f = V, last_upd = -1;
        for (int v = 0; v < im_f; ++v) {
            if (!(m.flag[v] & F_TV))
                continue;
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
        int sm_im_f = V;
        for (int v = 0; v < V; ++v)
            if ((m.flag[v] & F_SMALL) && m.smr_v[v] < 0.01) {
                sm_im_f = v;
                break;
            }
        double best = g.smr, new_smr = INF;
        int last_um = -1;
        for (int v = 0; v < sm_im_f; ++v) {
            if (!(m.flag[v] & F_SMALL))
                continue;
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
            for (int e = 0; e < E; ++e)
                m.emask[e] = e == rc;
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

    // ----- a decomposition starts (from a FAST or a TV1 fire)
    trig = trig || fire_fa;
    if (trig) {
        int* linr = x.linr;
        int* loutr = x.loutr;
        double* wy = x.wy;
        const int troot = fire_fa ? fa_f : tv_tgt;
        const int rt = clampi(troot, 0, V - 1);
        g.dret = fire_fa ? PC_FAST : tv_ret;
        g.dretc = fire_fa ? fa_f + 1 : tv_retc;
        if (fire_fa)
            g.fired = 1;
        for (int j = 0; j < DMAX; ++j) {
            linr[j] = m.lin[rt * DMAX + j];
            loutr[j] = m.lout[rt * DMAX + j];
        }
        // balance_vertex (scallop.cc:2486-2576)
        const double bw1 = m.inw[rt], bw2 = m.outw[rt];
        const double bww = sqrt(bw1 * bw2);
        const double r1 = bww / (bw1 == 0.0 ? 1.0 : bw1);
        const double r2 = bww / (bw2 == 0.0 ? 1.0 : bw2);
        const double m1 = bal_side(m, g, s, linr, r1, wy);
        const double m2 = bal_side(m, g, s, loutr, r2, wy);
        const int sur_out = clampi(loutr[0], 0, E - 1);
        const int sur_in = clampi(linr[0], 0, E - 1);
        m.ewrt[sur_out] = m.ewrt[sur_out] + (m1 > m2 ? m1 - m2 : 0.0);
        m.ewrt[sur_in] = m.ewrt[sur_in] + (m1 < m2 ? m2 - m1 : 0.0);
        // pairs: the single side against the multi side, in stamp order
        const int side = m.din[rt] == 1 ? 0 : 1;
        const int single_e = side == 0 ? linr[0] : loutr[0];
        const int* multi = side == 0 ? loutr : linr;
        int npairs = 0;
        for (int j = 0; j < DMAX; ++j)
            npairs += multi[j] >= 0;
        const int sc = clampi(single_e, 0, E - 1);
        const double w_single = m.ewrt[sc];
        double md = 0.0;
        for (int j = 0; j < DMAX; ++j) {
            const double wm = multi[j] >= 0
                ? m.ewrt[clampi(multi[j], 0, E - 1)] : 0.0;
            wy[j] = dmin(w_single, wm);
            md = md + (multi[j] >= 0 ? wy[j] : 0.0);
        }
        m.ewrt[sc] = md;
        for (int j = 0; j < DMAX; ++j)
            if (multi[j] >= 0)
                m.ewrt[multi[j]] = wy[j];
        // processing order: by multi-side edge id (stable, absent last)
        for (int j = 0; j < DMAX; ++j) {
            m.dp_e1[j] = multi[j];
            m.dp_w[j] = wy[j];
        }
        for (int j = 1; j < DMAX; ++j) {
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
        for (int j = 0; j < DMAX; ++j) {
            const int ms = m.dp_e1[j];
            m.dp_e1[j] = ms >= 0 ? (side == 0 ? single_e : ms) : -1;
            m.dp_e2[j] = ms >= 0 ? (side == 0 ? ms : single_e) : -1;
        }
        g.dp_n = npairs;
        g.dp_k = 0;
        g.dp_ms = npairs;
        g.dside = side;
        g.droot = troot;
        g.pc = PC_DECOMP;
        ovf = logd(m, g, s, ARM_TRIVIAL, troot) || ovf;
        bool deg_over = false;
        for (int v = 0; v < V; ++v)
            deg_over = deg_over || imax(m.din[v], m.dout[v]) > DMAX;
        ovf = ovf || npairs > DMAX || deg_over;
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
            // the root is erased once isolated
            int deg = 0;
            for (int e = 0; e < E; ++e)
                deg += m.ealive[e] && (m.edst[e] == rc || m.esrc[e] == rc);
            if (deg == 0)
                m.nz[rc] = 0;
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
            // all pairs done: the pair edges leave the hyper lists, the
            // root is erased, the arm that fired resumes
            for (int e = 0; e < E; ++e)
                m.emask[e] = 0;
            for (int j = 0; j < DMAX; ++j) {
                if (m.dp_e1[j] >= 0)
                    m.emask[m.dp_e1[j]] = 1;
                if (m.dp_e2[j] >= 0)
                    m.emask[m.dp_e2[j]] = 1;
            }
            g.do_rm = 1;
            m.nz[rc] = 0;
            g.pc = g.dret;
            g.cur = g.dretc;
        }
    }

    if (ovf) {
        g.pc = PC_DONE;
        g.status = ST_OVERFLOW;
    }
}

// ------------------------------------------------------------- the tables

// Degrees, strand degrees and the adjacency lists of this iteration.
LADDER_FN void build_lists(Smem& m, const Shape& s, int tid, int nt) {
    const int V = s.V, E = s.E, DMAX = s.DMAX;
    for (int i = tid; i < V * DMAX; i += nt) {
        m.lin[i] = -1;
        m.lout[i] = -1;
    }
    for (int v = tid; v < V; v += nt) {
        int di = 0, dq = 0, si[3] = {0, 0, 0}, so[3] = {0, 0, 0};
        for (int e = 0; e < E; ++e) {
            if (!m.ealive[e])
                continue;
            const int z = m.estr[e];
            if (m.edst[e] == v) {
                ++di;
                if (z >= 0 && z < 3)
                    ++si[z];
            }
            if (m.esrc[e] == v) {
                ++dq;
                if (z >= 0 && z < 3)
                    ++so[z];
            }
        }
        m.din[v] = di;
        m.dout[v] = dq;
        for (int z = 0; z < 3; ++z) {
            m.sin3[3 * v + z] = si[z];
            m.sout3[3 * v + z] = so[z];
        }
    }
    LADDER_SYNC();
    // each live edge's rank in its (vertex, stamp) list; ranks past DMAX
    // share the last slot, where the larger edge id stays
    for (int e = tid; e < E; e += nt) {
        if (!m.ealive[e])
            continue;
        const int d = m.edst[e], sr = m.esrc[e];
        const int ti = m.esin[e], to = m.esout[e];
        int ri = 0, ro = 0;
        for (int f = 0; f < E; ++f) {
            if (!m.ealive[f])
                continue;
            ri += m.edst[f] == d && m.esin[f] < ti;
            ro += m.esrc[f] == sr && m.esout[f] < to;
        }
        LADDER_ATOMIC_MAX(
            &m.lin[clampi(d, 0, V - 1) * DMAX + (ri < DMAX ? ri : DMAX - 1)],
            e);
        LADDER_ATOMIC_MAX(
            &m.lout[clampi(sr, 0, V - 1) * DMAX
                    + (ro < DMAX ? ro : DMAX - 1)], e);
    }
}

// Ordered sum along a list, and its last-min-wins smallest edge
// (compute_smallest_{in,out}_edge, scallop.cc:2967-3007).
LADDER_FN void list_stats(const Smem& m, const Shape& s, const int* lst,
                          double* sum, int* sm_e, double* sm_w) {
    double acc = 0.0, mn = INF;
    for (int j = 0; j < s.DMAX; ++j) {
        const bool ok = lst[j] >= 0;
        const double w = m.ewrt[clampi(lst[j], 0, s.E - 1)];
        acc = acc + (ok ? w : 0.0);
        mn = dmin(mn, ok ? w : INF);
    }
    int last = -1;
    for (int j = 0; j < s.DMAX; ++j)
        if (lst[j] >= 0 && m.ewrt[lst[j]] <= mn)
            last = j;
    *sum = acc;
    *sm_e = last >= 0 ? lst[last] : -1;
    *sm_w = mn;
}

// Per-vertex sums, ratios and the candidate flags of the arm that runs.
LADDER_FN void vertex_tables(Smem& m, const Scal& g, const Shape& s,
                             int tid, int nt, int pc0, int cur) {
    const int V = s.V, E = s.E, DMAX = s.DMAX;
    for (int v = tid; v < V; v += nt) {
        double w1, w2;
        list_stats(m, s, m.lin + v * DMAX, &w1, &m.sm_in_e[v],
                   &m.sm_in_w[v]);
        list_stats(m, s, m.lout + v * DMAX, &w2, &m.sm_out_e[v],
                   &m.sm_out_w[v]);
        m.inw[v] = w1;
        m.outw[v] = w2;
        const double balr = w1 >= w2 ? w1 / (w2 == 0.0 ? 1.0 : w2)
                                     : w2 / (w1 == 0.0 ? 1.0 : w1);
        m.balr[v] = balr;
        const int di = m.din[v], dq = m.dout[v];
        const bool active = v >= 1 && v < g.nv - 1 && m.nz[v];
        const int hi_c = clampi(m.lin[v * DMAX], 0, E - 1);
        const int ho_c = clampi(m.lout[v * DMAX], 0, E - 1);
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
        if (pc0 == PC_BROKEN && active && (di == 0 || dq == 0))
            f |= F_BROKEN;
        if (pc0 == PC_FAST && base_triv && cls1_nofast && balr < g.jump
            && ge_cur)
            f |= F_FAST;
        if (pc0 == PC_TV1 && base_triv && ge_cur) {
            // the dominate queries only where they decide
            const bool cls1_fast = cls1_nofast
                || (di == 1 && dominates(m, s, hi_c, true))
                || (dq == 1 && dominates(m, s, ho_c, false));
            if (cls1_fast)
                f |= F_TV;
        }
        if (pc0 == PC_SMALL) {
            const bool in_ok = m.sm_in_e[v] >= 0, out_ok = m.sm_out_e[v] >= 0;
            const double r_in = in_ok ? m.sm_in_w[v] / w1 : 0.0;
            const double r_out = out_ok ? m.sm_out_w[v] / w2 : 0.0;
            const bool use_in = r_in < r_out;
            const int sm_e = in_ok && out_ok
                ? (use_in ? m.sm_in_e[v] : m.sm_out_e[v]) : -1;
            m.sme_v[v] = sm_e;
            m.smr_v[v] = in_ok && out_ok ? (use_in ? r_in : r_out) : 0.0;
            const int smec = clampi(sm_e, 0, E - 1);
            const int es = m.esrc[smec], et = m.edst[smec];
            const bool deg_ok = m.dout[clampi(es, 0, V - 1)] > 1
                && m.din[clampi(et, 0, V - 1)] > 1;
            // the extend queries only where they decide
            if (active && di > 1 && dq > 1 && sm_e >= 0 && deg_ok && ge_cur) {
                bool le, re;
                extends(m, s, smec, &le, &re);
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
                if (ext_ok && str_ok)
                    f |= F_SMALL;
            }
        }
        m.flag[v] = f;
    }
}

// ------------------------------------------------------------ one graph

// Graph b's state from the inputs, by the nt threads of its block.
LADDER_FN void load_graph(Smem& m, Scal& g, const Shape& s, const In& in,
                          int b, int tid, int nt) {
    const int V = s.V, E = s.E, HL = s.H * s.L;
    for (int e = tid; e < E; e += nt) {
        const size_t i = (size_t)b * E + e;
        m.esrc[e] = in.esrc[i];
        m.edst[e] = in.edst[i];
        m.ewrt[e] = in.ewrt[i];
        m.estr[e] = in.estr[i];
        m.esin[e] = in.esin[i];
        m.esout[e] = in.esout[i];
        m.ealive[e] = in.ealive[i] != 0;
    }
    for (int v = tid; v < V; v += nt)
        m.nz[v] = in.nz[(size_t)b * V + v] != 0;
    for (int i = tid; i < HL; i += nt)
        m.hedge[i] = in.hedge[(size_t)b * HL + i];
    for (int h = tid; h < s.H; h += nt)
        m.hlen[h] = in.hlen[(size_t)b * s.H + h];
    for (int i = tid; i < s.DLOG; i += nt) {
        m.larm[i] = 0;
        m.ltgt[i] = 0;
    }
    for (int j = tid; j < s.DMAX; j += nt) {
        m.dp_e1[j] = -1;
        m.dp_e2[j] = -1;
        m.dp_w[j] = 0.0;
    }
    if (tid == 0) {
        g.nv = in.nv[b];
        g.pc = g.nv > 0 ? PC_BROKEN : PC_DONE;
        g.status = g.nv > 0 ? ST_RUN : ST_CLEAN;
        g.cur = 1;
        g.fired = 0;
        g.tvr = INF;
        g.tvroot = -1;
        g.jump = in.jump[b];
        g.smallr = in.smallr[b];
        g.guard = in.guard[b];
        g.smin = in.smin[b];
        g.smr = g.smallr;
        g.sme = -1;
        g.droot = -1;
        g.dp_n = g.dp_k = g.dp_ms = g.dside = g.dret = 0;
        g.dretc = 1;
        g.ndec = 0;
        g.nedges = in.nedges[b];
        g.nstamp = in.nstamp[b];
        g.it = 0;
    }
}

// The events of the loaded graph, to PC_DONE or maxiter.  Every thread of
// the block calls it: the exit test reads the shared state after a
// barrier, so all threads leave together.
LADDER_FN void run_graph(Smem& m, Scal& g, const Shape& s, Scratch& x,
                         int maxiter, int tid, int nt) {
    LADDER_SYNC();
    while (g.pc != PC_DONE && g.it < maxiter) {
        const int pc0 = g.pc, cur = g.cur;
        build_lists(m, s, tid, nt);
        LADDER_SYNC();
        vertex_tables(m, g, s, tid, nt, pc0, cur);
        LADDER_SYNC();
        if (tid == 0) {
            event(m, g, s, x);
            g.it += 1;
        }
        LADDER_SYNC();
        apply_hyper(m, g, s, tid, nt);
        LADDER_SYNC();
    }
}

// Graph b's 13 outputs and its event count.
LADDER_FN void store_graph(const Smem& m, const Scal& g, const Shape& s,
                           const Out& out, int b, int tid, int nt) {
    const int V = s.V, E = s.E, HL = s.H * s.L;
    if (tid == 0) {
        out.ndec[b] = g.ndec;
        out.status[b] = g.status == ST_RUN ? ST_OVERFLOW : g.status;
        out.nedges[b] = g.nedges;
        out.events[b] = g.it;
    }
    for (int e = tid; e < E; e += nt) {
        const size_t i = (size_t)b * E + e;
        out.ewrt[i] = m.ewrt[e];
        out.ealive[i] = m.ealive[e];
        out.esrc[i] = m.esrc[e];
        out.edst[i] = m.edst[e];
        out.estr[i] = m.estr[e];
    }
    for (int i = tid; i < s.DLOG; i += nt) {
        out.larm[(size_t)b * s.DLOG + i] = m.larm[i];
        out.ltgt[(size_t)b * s.DLOG + i] = m.ltgt[i];
    }
    for (int i = tid; i < HL; i += nt)
        out.hedge[(size_t)b * HL + i] = m.hedge[i];
    for (int h = tid; h < s.H; h += nt)
        out.hlen[(size_t)b * s.H + h] = m.hlen[h];
    for (int v = tid; v < V; v += nt)
        out.nz[(size_t)b * V + v] = m.nz[v];
}

// Whether the kernel takes this shape (the event's scratch lists hold
// MAX_DMAX entries).
LADDER_HD bool shape_ok(const Shape& s) {
    return s.V >= 1 && s.E >= 1 && s.H >= 1 && s.L >= 1 && s.DMAX >= 1
        && s.DMAX <= MAX_DMAX && s.DLOG >= 1;
}

}  // namespace ladder
