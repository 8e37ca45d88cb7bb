// The per-instance machine of the bridge top-K kernel (bridge.cu): one
// pier-DP instance's inputs and tables in shared memory and its V - 1
// steps.
//
// nvcc compiles it for the card, where a block of `nt` threads shares each
// step's candidates; a host compiler compiles the same code for one thread
// (bridge_host.cpp), where the barriers are no-ops and the atomic a plain
// increment: the CPU tests hold that build against the plain PyTorch form,
// the JAX package's program and the numpy oracle, so the transcription is
// tested where no card is.  All arithmetic is on int32 (the length sum and
// the key negation wrap, done unsigned so that C++ defines them).

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define BRIDGE_HD __host__ __device__ inline
#define BRIDGE_FN __device__ inline
#define BRIDGE_SYNC() __syncthreads()
#define BRIDGE_NEXT_SLOT(p) atomicAdd((p), 1)
#else
#define BRIDGE_HD inline
#define BRIDGE_FN inline
#define BRIDGE_SYNC() ((void)0)
#define BRIDGE_NEXT_SLOT(p) ((*(p))++)
#endif

namespace bridge {

// ops/constants.py: BRIDGE_K, BRIDGE_S, BRIDGE_SENTINEL, BRIDGE_BIG
constexpr int K = 10;               // entries kept a vertex
constexpr int S = 5;                // stack depth of an entry
constexpr int NKEY = S + 1;         // sort keys: -stack[0..S-1], length
constexpr int SENTINEL = 999999;    // the source's stack fill
constexpr int BIG = 1 << 30;        // every key of an absent candidate

struct Shape {
    int V, E, T;
};

// the inputs, [n, ...] row-major: P, Wt [n, V, E], Lv [n, V], tgt [n, T]
struct In {
    const int *P, *Wt, *Lv, *tgt;
};

// the outputs: ostk [n, T, K, S], par, pix [n, V, K]
struct Out {
    int *ostk, *par, *pix;
};

// one instance's inputs and tables (shared memory on the card); a step's
// N = E K candidates sit at positions e K + i, its valid ones in slots
// 0..nvalid-1 in no order
struct Smem {
    int *P, *Wt, *Lv;   // [V, E], [V, E], [V] the instance's inputs
    int* stk;           // [V, K, S] the entries' stacks
    int* ln;            // [V, K] their lengths
    int* key;           // [NKEY, N] the valid candidates' keys, by slot
    int* pos;           // [N] their positions, by slot
    int* slot;          // [N] each position's slot, -1 when absent
    int* nvalid;        // [2] the valid count, of odd and even steps
    uint8_t* val;       // [V, K] entry valid
};

// Smem's arrays laid out from base (i32 first, then u8); returns the bytes
// they take.  base == nullptr computes the size only.
BRIDGE_HD size_t carve(char* base, const Shape& s, Smem* m) {
    const size_t V = s.V, VE = V * s.E, N = (size_t)s.E * K;
    const size_t n32[9] = {VE, VE, V, V * K * S, V * K, NKEY * N, N, N, 2};
    int* p32[9];
    size_t off = 0;
    for (int i = 0; i < 9; ++i) {
        p32[i] = base ? (int*)(base + off) : nullptr;
        off += n32[i] * sizeof(int);
    }
    uint8_t* val = base ? (uint8_t*)(base + off) : nullptr;
    off += V * K;
    if (m)
        *m = Smem{p32[0], p32[1], p32[2], p32[3], p32[4], p32[5], p32[6],
                  p32[7], p32[8], val};
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

// Candidate c's place in the stable order of all N candidates by their
// keys `own` (ties by position), or a number >= K when it is not among
// the first K.  Only the valid ones are visited, in slot order, their
// first key before the rest: every absent candidate has the keys (BIG,
// ..., BIG), and absent ones keep their position order, so they count in
// closed form.
BRIDGE_HD int rank_of(const Smem& m, int N, int nv, int c,
                      const int* own) {
    int r = 0, before = 0;      // valid ones ahead in order, in position
    for (int q = 0; q < nv && r < K; ++q) {
        const int c2 = m.pos[q];
        int d = 0;
        for (int j = 0; j < NKEY && d == 0; ++j) {
            const int x = m.key[j * N + q];
            d = x < own[j] ? -1 : x > own[j];
        }
        before += c2 < c;
        r += d < 0 || (d == 0 && c2 < c);
    }
    if (r >= K)
        return r;
    int db = 0;                 // an absent candidate's keys against own
    for (int j = 0; j < NKEY && db == 0; ++j)
        db = BIG < own[j] ? -1 : BIG > own[j];
    if (db < 0)
        r += N - nv;            // every absent candidate comes first
    else if (db == 0)
        r += c - before;        // the absent ones at smaller positions
    return r;
}

// One instance, b, from its inputs to its outputs.  Thread tid of nt.
BRIDGE_FN void run_instance(const Smem& m, const Shape& s, const In& in,
                            const Out& out, int b, int tid, int nt) {
    const int V = s.V, E = s.E, T = s.T, N = E * K;
    const int* tgt = in.tgt + (size_t)b * T;
    int* par = out.par + (size_t)b * V * K;
    int* pix = out.pix + (size_t)b * V * K;
    int* ostk = out.ostk + (size_t)b * T * K * S;

    for (int x = tid; x < V * E; x += nt) {
        m.P[x] = in.P[(size_t)b * V * E + x];
        m.Wt[x] = in.Wt[(size_t)b * V * E + x];
    }
    for (int x = tid; x < V; x += nt)
        m.Lv[x] = in.Lv[(size_t)b * V + x];
    // vertex 0 holds one entry: the sentinel stack and its own length
    for (int x = tid; x < V * K * S; x += nt)
        m.stk[x] = x < S ? SENTINEL : -1;
    for (int x = tid; x < V * K; x += nt) {
        m.ln[x] = x == 0 ? in.Lv[(size_t)b * V] : 0;
        m.val[x] = x == 0;
    }
    // row 0 of par and pix; every later row gets all K slots in its step
    for (int x = tid; x < K; x += nt)
        par[x] = pix[x] = -1;
    if (tid == 0)
        m.nvalid[0] = m.nvalid[1] = 0;
    BRIDGE_SYNC();

    for (int k = 1; k < V; ++k) {
        int* nvalid = m.nvalid + (k & 1);
        // the next step's count, last read in the previous step's ranks
        if (tid == 0)
            m.nvalid[(k + 1) & 1] = 0;
        // candidates: (in-edge slot e, predecessor entry i) at e K + i,
        // its stack with w inserted (update_stack) and its length
        for (int c = tid; c < N; c += nt) {
            const int e = c / K, i = c - e * K;
            const int p = m.P[k * E + e];
            if (p < 0 || p >= V || !m.val[p * K + i]) {
                m.slot[c] = -1;
                continue;
            }
            const int q = BRIDGE_NEXT_SLOT(nvalid);
            const int w = m.Wt[k * E + e];
            const int* g = m.stk + (p * K + i) * S;
            int cnt = 0;                // elements <= w: w's place
            for (int j = 0; j < S; ++j)
                cnt += g[j] <= w;
            for (int j = 0; j < S; ++j) {
                const int v = j < cnt ? g[j] : j == cnt ? w : g[j - 1];
                m.key[j * N + q] = neg(v);
            }
            m.key[S * N + q] = wrap_add(m.ln[p * K + i], m.Lv[k]);
            m.pos[q] = c;
            m.slot[c] = q;
        }
        BRIDGE_SYNC();
        // the first K in order fill vertex k's slots (N >= K: all of
        // them); nothing here reads the tables they write
        const int nv = *nvalid;
        for (int c = tid; c < N; c += nt) {
            const int q = m.slot[c];
            int own[NKEY];
            for (int j = 0; j < NKEY; ++j)
                own[j] = q >= 0 ? m.key[j * N + q] : BIG;
            const int r = rank_of(m, N, nv, c, own);
            if (r >= K)
                continue;
            const int e = c / K, i = c - e * K;
            int* st = m.stk + (k * K + r) * S;
            for (int j = 0; j < S; ++j)
                st[j] = q >= 0 ? neg(own[j]) : -1;
            m.ln[k * K + r] = q >= 0 ? own[S] : 0;
            m.val[k * K + r] = q >= 0;
            par[k * K + r] = q >= 0 ? m.P[k * E + e] : -1;
            pix[k * K + r] = q >= 0 ? i : -1;
        }
        BRIDGE_SYNC();
    }

    // the stacks at the targets; -1 for an absent target or entry
    for (int x = tid; x < T * K * S; x += nt) {
        const int t = x / (K * S), i = x / S % K, j = x % S;
        const int v = tgt[t];
        const bool ok = v >= 0 && v < V && m.val[v * K + i];
        ostk[x] = ok ? m.stk[(v * K + i) * S + j] : -1;
    }
}

}  // namespace bridge
