// The per-instance machine of the bridge top-K kernel (bridge.cu): one
// pier-DP instance's inputs and tables in shared memory and its steps, run
// by the lanes of one warp.
//
// nvcc compiles it for the card, where a warp of 32 lanes runs an instance
// with the warp's vote, reduction and shuffle instructions (team.cuh) and
// no block barrier; a host compiler compiles the same code for a team of
// nt <= 32 std::threads standing in for the lanes (bridge_host.cpp): the
// CPU tests hold that build against the plain PyTorch form, the JAX
// package's program and the numpy oracle at several lane counts, so the
// transcription is tested where no card is.  All arithmetic is on int32
// (the length sum and the key negation wrap, done unsigned so that C++
// defines them).
//
// A step, vertex k: the candidates (in-edge slot e, entry i of the slot's
// predecessor) at positions c = e K + i; a valid one takes the entry's
// stack with the edge weight inserted and its length plus Lv[k], and the
// keys (-stack[0..S-1], length).  The first K of all E K candidates in the
// stable order of (keys, position) fill vertex k's entries.  An absent
// candidate (no such predecessor or entry) has the keys (BIG, ..., BIG)
// and fills an entry with (-1 stack, 0 length, invalid, -1 parent and
// entry index), whichever it is: so the valid candidates are sorted among
// themselves, and the absent ones only decide how many rows come before a
// valid one.  Where every valid key tuple sorts before (BIG, ..., BIG), the
// j-th valid one fills entry j; a tuple at or past it (only keys that wrap
// int32, tests/test_torch_bridge_kernel.py) has the absent ones that sort
// ahead of it added in closed form, as the plain form's order has them.

#pragma once

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "team.cuh"

#ifdef __CUDACC__
#define BRIDGE_HD __host__ __device__ inline
#define BRIDGE_FN __device__ inline
#define BRIDGE_CLOCK() ((unsigned long long)clock64())
#else
#define BRIDGE_HD inline
#define BRIDGE_FN inline
#define BRIDGE_CLOCK() 0ull
#endif

namespace bridge {

using team::Lanes;

// ops/constants.py: BRIDGE_K, BRIDGE_S, BRIDGE_SENTINEL, BRIDGE_BIG
constexpr int K = 10;               // entries kept a vertex
constexpr int S = 5;                // stack depth of an entry
constexpr int NKEY = S + 1;         // sort keys: -stack[0..S-1], length
constexpr int SENTINEL = 999999;    // the source's stack fill
constexpr int BIG = 1 << 30;        // every key of an absent candidate
static_assert(K <= 32, "a vertex's entries are the bits of one word");

// the profiling instance's counters (bridge.cu, aletsch_bridge_topk_prof):
// clock64() cycles of each pass on lane 0, summed over the instances, then
// counts; ops/bridge_topk.py PROF_PASSES and PROF_COUNTS name them
enum {
    PROF_LOAD,      // inputs into shared memory, the tables set to -1
    PROF_BUILD,     // a step with candidates: its row read, its candidates
    PROF_SELECT,    // its selection rounds
    PROF_WRITE,     // its entries written
    PROF_EMPTY,     // a step with no valid candidate (its row read)
    PROF_OUT,       // the stacks at the targets' valid entries stored
    PROF_STEPS,     // steps run
    PROF_NEMPTY,    // of them with no valid candidate
    PROF_TAIL,      // steps past the instance's last live vertex, not run
    PROF_CANDS,     // valid candidates over the steps
    NPROF
};

struct Shape {
    int V, E, T;
};

// the inputs, each [n, ...] with row b at b * stride elements (sP, sW, sL,
// sT) and each row contiguous: P, Wt [V, E], Lv [V], tgt [T]
struct In {
    const int *P, *Wt, *Lv, *tgt;
    int sP, sW, sL, sT;
};

// the outputs, dense: ostk [n, T, K, S], par, pix [n, V, K]
struct Out {
    int *ostk, *par, *pix;
};

// one instance's inputs and tables (shared memory on the card); a step's
// candidates by position c < N = E K
struct Smem {
    int *P, *Wt, *Lv;   // [V, E], [V, E], [V] the instance's inputs
    int* tgt;           // [T]
    int* stk;           // [V, K, S] the entries' stacks (valid ones only
                        // are ever written or read)
    int* ln;            // [V, K] their lengths (likewise)
    int* vmask;         // [V] bit i set: entry i of the vertex is valid
    int* ck;            // [NKEY + 1, N] a valid candidate's keys, then the
                        // valid ones at smaller positions (-1: not valid)
    int* win;           // [K] the position that fills each entry
};

// Smem's arrays laid out from base, each 16-byte aligned (for the vector
// copies); returns the bytes they take.  base == nullptr computes the size
// only.
BRIDGE_HD size_t carve(char* base, const Shape& s, Smem* m) {
    const size_t V = s.V, VE = V * s.E, N = (size_t)s.E * K;
    const size_t n32[9] = {VE, VE, V, (size_t)s.T, V * K * S, V * K, V,
                           (NKEY + 1) * N, K};
    int* p32[9];
    size_t off = 0;
    for (int i = 0; i < 9; ++i) {
        p32[i] = base ? (int*)(base + off) : nullptr;
        off += (n32[i] * sizeof(int) + 15) / 16 * 16;
    }
    if (m)
        *m = Smem{p32[0], p32[1], p32[2], p32[3], p32[4], p32[5], p32[6],
                  p32[7], p32[8]};
    return off;
}

BRIDGE_HD bool shape_ok(const Shape& s) {
    return s.V >= 1 && s.E >= 1 && s.T >= 0;
}

// -x and a + b with int32 wrap-around, as torch's and XLA's i32 ops
BRIDGE_HD int neg(int x) { return (int)(0u - (unsigned)x); }
BRIDGE_HD int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// -1, 0, 1 as the tuple key[0..NKEY-1] sorts before, with, after (BIG,
// ..., BIG): an absent candidate's keys
BRIDGE_HD int cmp_big(const int* key) {
    for (int j = 0; j < NKEY; ++j)
        if (key[j] != BIG)
            return key[j] < BIG ? -1 : 1;
    return 0;
}

// (a, position ca) before (b, cb) in the stable order
BRIDGE_HD bool before(const int* a, int ca, const int* b, int cb) {
    for (int j = 0; j < NKEY; ++j)
        if (a[j] != b[j])
            return a[j] < b[j];
    return ca < cb;
}

// The lane's first valid candidate after (h, hc) in the order among its
// positions c = tid, tid + nl, ... below nc (keys and validity in ck [NKEY
// + 1, N], as run_instance builds it): into (h, hc), false if none.
BRIDGE_HD bool lane_next(const int* ck, int N, int nc, int tid, int nl,
                         int* h, int& hc) {
    int last[NKEY];
    const int lc = hc;
    for (int j = 0; j < NKEY; ++j)
        last[j] = h[j];
    bool has = false;
    for (int c = tid; c < nc; c += nl) {
        if (ck[NKEY * N + c] < 0)
            continue;
        int key[NKEY];
        for (int j = 0; j < NKEY; ++j)
            key[j] = ck[j * N + c];
        if (before(last, lc, key, c) && (!has || before(key, c, h, hc))) {
            for (int j = 0; j < NKEY; ++j)
                h[j] = key[j];
            hc = c;
            has = true;
        }
    }
    return has;
}

// Start the lanes' copy of src[0, n) into shared dst[0, n): on the card an
// asynchronous copy (cp.async, which holds no register) in 16-byte pieces
// where both are aligned and n divides by 4, else an int a lane.  The
// copies are complete at copies_done(); the caller then syncs the lanes.
BRIDGE_FN void copy_start(int* dst, const int* src, int n, const Lanes& w) {
    if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && n % 4 == 0) {
        for (int x = 4 * w.tid; x < n; x += 4 * w.nt) {
#ifdef __CUDACC__
            const unsigned to =
                (unsigned)__cvta_generic_to_shared(dst + x);
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(to), "l"(src + x));
#else
            memcpy(dst + x, src + x, 4 * sizeof(int));
#endif
        }
        return;
    }
    for (int x = w.tid; x < n; x += w.nt)
        dst[x] = src[x];
}

BRIDGE_FN void copies_done() {
#ifdef __CUDACC__
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// fill[0, n) = -1 in device memory by the lanes, in 16-byte stores where
// aligned
BRIDGE_FN void fill_minus1(int* fill, int n, const Lanes& w) {
    if (((uintptr_t)fill & 15) == 0 && n % 4 == 0) {
        for (int x = 4 * w.tid; x < n; x += 4 * w.nt) {
#ifdef __CUDACC__
            *reinterpret_cast<int4*>(fill + x) = make_int4(-1, -1, -1, -1);
#else
            for (int j = 0; j < 4; ++j)
                fill[x + j] = -1;
#endif
        }
        return;
    }
    for (int x = w.tid; x < n; x += w.nt)
        fill[x] = -1;
}

// The last row r of P [rows, width] (shared) that holds a value in [0, hi),
// -1 if none: on each lane, its part; the caller's maximum over the lanes
// gives the whole.
BRIDGE_FN int last_live_row(const int* P, int n, int width, int hi,
                            const Lanes& w) {
    int last = -1;
    if (((uintptr_t)P & 15) == 0 && n % 4 == 0) {
        for (int x = 4 * w.tid; x < n; x += 4 * w.nt) {
            int v[4];
#ifdef __CUDACC__
            const int4 q = *reinterpret_cast<const int4*>(P + x);
            v[0] = q.x;
            v[1] = q.y;
            v[2] = q.z;
            v[3] = q.w;
#else
            memcpy(v, P + x, sizeof v);
#endif
            for (int j = 0; j < 4; ++j)
                if (v[j] >= 0 && v[j] < hi)
                    last = (x + j) / width;
        }
        return last;
    }
    for (int x = w.tid; x < n; x += w.nt)
        if (P[x] >= 0 && P[x] < hi)
            last = x / width;
    return last;
}

// One instance, b, from its inputs to its outputs, on the lanes w.
// PROF: lane 0 reads the clock at the lanes' sync points and adds each
// pass's cycles and the counts to acc[NPROF].
template <bool PROF>
BRIDGE_FN void run_instance(const Smem& m, const Shape& s, const In& in,
                            const Out& out, int b, Lanes& w,
                            unsigned long long* acc) {
    const int V = s.V, E = s.E, T = s.T, N = E * K;
    const int tid = w.tid, nl = w.nt;
    int* ostk = out.ostk + (size_t)b * T * K * S;
    int* par = out.par + (size_t)b * V * K;
    int* pix = out.pix + (size_t)b * V * K;
    unsigned long long t0 = PROF ? BRIDGE_CLOCK() : 0ull;
    // lane 0 adds the cycles since the last lap to the pass
    auto lap = [&](int pass) {
        if (PROF && tid == 0) {
            const unsigned long long t1 = BRIDGE_CLOCK();
            acc[pass] += t1 - t0;
            t0 = t1;
        }
    };

    // the inputs, in flight together; meanwhile the outputs -1 (every
    // entry invalid) and vertex 0's entry: the sentinel stack and its own
    // length
    copy_start(m.P, in.P + (size_t)b * in.sP, V * E, w);
    copy_start(m.Wt, in.Wt + (size_t)b * in.sW, V * E, w);
    copy_start(m.Lv, in.Lv + (size_t)b * in.sL, V, w);
    copy_start(m.tgt, in.tgt + (size_t)b * in.sT, T, w);
    fill_minus1(par, V * K, w);
    fill_minus1(pix, V * K, w);
    fill_minus1(ostk, T * K * S, w);
    for (int x = tid; x < V; x += nl)
        m.vmask[x] = x == 0;
    for (int x = tid; x < S; x += nl)
        m.stk[x] = SENTINEL;
    if (tid == 0)
        m.ln[0] = in.Lv[(size_t)b * in.sL];
    copies_done();
    team::lanes_sync(w);
    // the last vertex with a live in-edge bounds the steps
    const int vlive =
        team::lanes_max(w, last_live_row(m.P, V * E, E, V, w)) + 1;
    lap(PROF_LOAD);

    for (int k = 1; k < vlive; ++k) {
        const int* Pk = m.P + k * E;
        // the in-edge row: ne - 1 is its last slot whose predecessor holds
        // an entry; none makes the step closed-form (every entry invalid,
        // as initialised).  With a slot a lane (E <= lanes), lane e keeps
        // its slot's predecessor and entry bits for the candidates.
        int elast = -1, pe = -1, vme = 0;
        for (int e = tid; e < E; e += nl) {
            const int p = Pk[e];
            const int vm = p >= 0 && p < V ? m.vmask[p] : 0;
            if (vm != 0)
                elast = e;
            pe = p;
            vme = vm;
        }
        const int ne = team::lanes_max(w, elast) + 1;
        if (ne == 0) {
            lap(PROF_EMPTY);
            if (PROF && tid == 0) {
                acc[PROF_STEPS] += 1;
                acc[PROF_NEMPTY] += 1;
            }
            continue;
        }

        // the candidates at positions c < ne K, lane-strided: a valid one's
        // keys and the count of valid ones ahead of it by position into ck
        // (-1 there for one not valid); each lane keeps the first of its
        // own in the order (its head) in registers
        const int nc = ne * K, Lk = m.Lv[k];
        int* ahead = m.ck + NKEY * N;
        int nv = 0;                     // valid ones so far, on every lane
        bool has = false, odd = false;
        int h[NKEY], hc = -1;
        for (int c0 = 0; c0 < nc; c0 += nl) {
            const int c = c0 + tid;
            int e = 0, i = 0, p = -1;
            bool valid = false;
            if (c < nc) {
                e = c / K;
                i = c - e * K;
            }
            int vm;
            if (E <= nl) {
                p = team::bcast(w, pe, e);
                vm = team::bcast(w, vme, e);
            } else {
                p = c < nc ? Pk[e] : -1;
                vm = p >= 0 && p < V ? m.vmask[p] : 0;
            }
            valid = c < nc && (vm >> i & 1);
            const unsigned bal = team::ballot(w, valid);
            if (c < nc)
                ahead[c] = valid ? nv + team::bit_count(
                                       bal & ((1u << tid) - 1u))
                                 : -1;
            if (valid) {
                // update_stack: w's place is the count of elements <= w
                const int wgt = m.Wt[k * E + e];
                const int* g = m.stk + (p * K + i) * S;
                int gv[S], cnt = 0;
                for (int j = 0; j < S; ++j) {
                    gv[j] = g[j];
                    cnt += gv[j] <= wgt;
                }
                int key[NKEY];
                for (int j = 0; j < S; ++j)
                    key[j] = neg(j < cnt ? gv[j]
                                 : j == cnt ? wgt : gv[j > 0 ? j - 1 : 0]);
                key[S] = wrap_add(m.ln[p * K + i], Lk);
                for (int j = 0; j < NKEY; ++j)
                    m.ck[j * N + c] = key[j];
                odd = odd || cmp_big(key) >= 0;
                if (!has || before(key, c, h, hc)) {
                    for (int j = 0; j < NKEY; ++j)
                        h[j] = key[j];
                    hc = c;
                    has = true;
                }
            }
            nv += team::bit_count(bal);
        }
        // some valid tuple at or past (BIG, ..., BIG): the absent ones
        // ahead of it count
        odd = team::ballot(w, odd) != 0;
        lap(PROF_BUILD);

        // the first K in order: a round takes the least head over the
        // lanes; the winner notes its position against the entry and
        // rescans its own candidates for the next head
        unsigned rows = 0;
        const int need = nv < K ? nv : K;
        for (int r0 = 0; r0 < need; ++r0) {
            const int wl = team::lex_argmin<NKEY>(w, has, h, hc);
            int r = r0;
            if (odd) {
                int rr = 0;
                if (tid == wl) {
                    const int cb = cmp_big(h);
                    rr = r0 + (cb < 0 ? 0 : cb > 0 ? N - nv
                               : hc - ahead[hc]);
                }
                r = team::bcast(w, rr, wl);
                if (r >= K)
                    break;
            }
            rows |= 1u << r;
            if (tid == wl) {
                m.win[r] = hc;
                has = lane_next(m.ck, N, nc, tid, nl, h, hc);
            }
        }
        lap(PROF_SELECT);
        team::lanes_sync(w);

        // vertex k's entries, a lane an entry; the rest stay invalid
        for (int r = tid; r < K; r += nl) {
            if (!(rows >> r & 1))
                continue;
            const int c = m.win[r], e = c / K;
            int* st = m.stk + (k * K + r) * S;
            for (int j = 0; j < S; ++j)
                st[j] = neg(m.ck[j * N + c]);
            m.ln[k * K + r] = m.ck[S * N + c];
            par[k * K + r] = Pk[e];
            pix[k * K + r] = c - e * K;
        }
        if (tid == 0)
            m.vmask[k] = (int)rows;
        team::lanes_sync(w);
        lap(PROF_WRITE);
        if (PROF && tid == 0) {
            acc[PROF_STEPS] += 1;
            acc[PROF_CANDS] += nv;
        }
    }
    if (PROF && tid == 0)
        acc[PROF_TAIL] += V - (vlive > 1 ? vlive : 1);

    // the stacks at the targets' valid entries, an entry a lane (the rest
    // stay -1, as filled)
    for (int x = tid; x < T * K; x += nl) {
        const int t = x / K, i = x - t * K, v = m.tgt[t];
        if (v < 0 || v >= V || !(m.vmask[v] >> i & 1))
            continue;
        const int* st = m.stk + (v * K + i) * S;
        for (int j = 0; j < S; ++j)
            ostk[x * S + j] = st[j];
    }
    lap(PROF_OUT);
}

}  // namespace bridge
