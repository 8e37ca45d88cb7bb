// The ladder kernel's per-graph machine (ladder_machine.cuh) built by a host
// compiler: a block of nt std::threads runs each graph, graph after graph,
// with the host form of the block primitives (ladder_block.cuh over
// team.cuh: a std::barrier for __syncthreads, std::atomic_ref for the
// atomics).  The
// CPU tests hold it against the plain PyTorch form at one thread and at
// several (tests/test_torch_ladder_kernel.py, test_torch_ladder_threads.py),
// so the transcription that ladder.cu runs on the card, and the split of
// its parallel passes, are exercised where no card is.  Build:
//     g++ -std=c++20 -O2 -ffp-contract=off -pthread -shared -fPIC
//         -o libladder_host.so ladder_host.cpp
// (-ffp-contract=off: no fused multiply-add, as nvcc -fmad=false).

#include <stdint.h>
#include <stdlib.h>

#include "ladder_machine.cuh"

using namespace ladder;

// aletsch_ladder_f64's arguments but the stream, and nt, the threads of
// the block (1 or more).  Returns 0, or 1 for a shape the kernel does not
// take, 2 when memory runs out.
extern "C" int aletsch_ladder_host(
    const int* esrc, const int* edst, const double* ewrt, const int* estr,
    const int* esin, const int* esout, const uint8_t* ealive,
    const int* nedges, const int* nstamp, const uint8_t* nz,
    const int* hedge, const int* hlen, const int* nv, const double* jump,
    const double* smallr, const double* guard, const double* smin, int B,
    int V, int E, int H, int L, int DMAX, int DLOG, int maxiter, int* larm,
    int* ltgt, int* ndec, int* status, double* ewrt_out,
    uint8_t* ealive_out, int* esrc_out, int* edst_out, int* estr_out,
    int* nedges_out, int* hedge_out, int* hlen_out, uint8_t* nz_out,
    int* events, const long long* in_stride, int nt) {
    const Shape s{V, E, H, L, DMAX, DLOG};
    if (!shape_ok(s) || nt < 1)
        return 1;
    char* buf = (char*)malloc(carve(nullptr, s, nullptr) + 16);
    if (!buf)
        return 2;
    Smem m;
    carve(buf, s, &m);
    Scal g;
    Scratch x;
    In in{esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp, nz,
          hedge, hlen, nv, jump, smallr, guard, smin, {}};
    for (int i = 0; i < 17; ++i)
        in.st[i] = in_stride[i];
    const Out out{larm, ltgt, ndec, status, ewrt_out, ealive_out,
                  esrc_out, edst_out, estr_out, nedges_out, hedge_out,
                  hlen_out, nz_out, events};
    team::run_team(nt, [&](Blk& b) {
        for (int gb = 0; gb < B; ++gb) {
            load_graph(m, g, s, in, gb, b);
            run_graph<false>(m, g, s, x, maxiter, b, nullptr);
            store_graph(m, g, s, out, gb, b);
            b.sync();
        }
    });
    free(buf);
    return 0;
}

// The block primitives on nt threads, for the tests.  kind 0: blk_min of
// each thread's least in[i] over its items i = tid, tid + nt, ... < n;
// 1, 2: blk_or, blk_and of whether any / every item of the thread is
// nonzero; 3: the first i with in[i] != 0 (n if none), as the flags pass
// finds the first candidate; out[tid] is what thread tid got.  kind 4:
// blk_scan of in[0, n) into out[0, n].  Returns 0, or 1 for a kind it
// does not know.
extern "C" int aletsch_ladder_block_host(int kind, int nt, const int* in,
                                         int n, int* out) {
    if (kind < 0 || kind > 4 || nt < 1)
        return 1;
    team::run_team(nt, [&](Blk& b) {
        if (kind == 4) {
            blk_scan(b, in, out, n);
            return;
        }
        int mn = BIGI, first = n;
        bool any = false, every = true;
        for (int i = b.tid; i < n; i += b.nt) {
            mn = in[i] < mn ? in[i] : mn;
            any = any || in[i] != 0;
            every = every && in[i] != 0;
            if (in[i] != 0 && i < first)
                first = i;
        }
        int r = 0;
        if (kind == 0)
            r = blk_min(b, mn);
        else if (kind == 1)
            r = blk_or(b, any);
        else if (kind == 2)
            r = blk_and(b, every);
        else
            r = blk_min(b, first);
        out[b.tid] = r;
    });
    return 0;
}

// The hyper-list updates and the occurrence index on nt threads, for the
// tests: apply_pair and apply_entries with the update op selects (0:
// replace the pair [x, y] by e, 1: the single x by e, 2: remove the edges
// marked in emask [E]) on hedge [H, L] and hlen [H], in place; then the
// occurrence index built (occ_ofs [E + 1], occ [H L]) and, for every edge
// e, dominates(e, right) into dom[2 e + right] and extends(e) into ext[2 e]
// (left) and ext[2 e + 1] (right).  Returns 0, or 1 for an op it does not
// know.
extern "C" int aletsch_ladder_occ_host(int nt, int H, int L, int E, int op,
                                       int x, int y, int e,
                                       const uint8_t* emask, int* hedge,
                                       int* hlen, int* occ_ofs, int* occ,
                                       uint8_t* dom, uint8_t* ext) {
    if (op < 0 || op > 2 || nt < 1 || H < 1 || L < 1 || E < 1)
        return 1;
    const Shape s{1, E, H, L, 1, 1};
    char* buf = (char*)malloc(carve(nullptr, s, nullptr) + 16);
    if (!buf)
        return 2;
    Smem m;
    carve(buf, s, &m);
    Scal g{};
    g.do_pair = op == 0;
    g.do_s1 = op == 1;
    g.do_rm = op == 2;
    g.mark = 0;
    g.hx = g.hx1 = x;
    g.hy = y;
    g.he = e;
    for (int i = 0; i < H * L; ++i) {
        m.hedge[i / L * lpitch(s) + i % L] = hedge[i];
        m.occ[i] = -1;
    }
    for (int h = 0; h < H; ++h)
        m.hlen[h] = hlen[h];
    for (int i = 0; i < E; ++i) {
        m.emark[i] = op == 2 && emask[i] ? 0 : -1;
        m.occ_cnt[i] = 0;
    }
    team::run_team(nt, [&](Blk& b) {
        apply_pair(m, g, s, b);
        apply_entries(m, g, s, b, 0);
        b.sync();
        occ_count(m, s, b);
        b.sync();
        occ_scatter(m, s, b);
        for (int ec = b.tid; ec < E; ec += b.nt) {
            bool le, re;
            extends(m, s, ec, &le, &re);
            ext[2 * ec] = le;
            ext[2 * ec + 1] = re;
            dom[2 * ec] = dominates(m, s, ec, false);
            dom[2 * ec + 1] = dominates(m, s, ec, true);
        }
    });
    for (int i = 0; i < H * L; ++i) {
        hedge[i] = m.hedge[i / L * lpitch(s) + i % L];
        occ[i] = m.occ[i];
    }
    for (int h = 0; h < H; ++h)
        hlen[h] = m.hlen[h];
    for (int i = 0; i <= E; ++i)
        occ_ofs[i] = m.occ_ofs[i];
    free(buf);
    return 0;
}
