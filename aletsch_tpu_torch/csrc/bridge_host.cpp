// The bridge top-K kernel's per-instance machine (bridge_machine.cuh) built
// by a host compiler: a team of nt std::threads stands in for the warp's
// lanes (team.cuh: a std::barrier and a slot a thread for the warp's vote,
// reduction and shuffle) and runs the instances one after another.  The
// CPU tests hold it against the plain PyTorch form, the JAX package's
// program and the numpy oracle at one thread and at several
// (tests/test_torch_bridge_kernel.py, test_torch_bridge_threads.py), so
// the transcription that bridge.cu runs on the card, and the split of a
// step over the lanes, are exercised where no card is.  Build:
//     g++ -std=c++20 -O2 -pthread -shared -fPIC -o libbridge_host.so
//         bridge_host.cpp

#include <stdlib.h>

#include "bridge_machine.cuh"

using namespace bridge;

// aletsch_bridge_topk_prof's arguments but the stream (prof may be null:
// no counts; the host's clock reads 0, so only the counts are kept), and
// nt, the lanes (1 to 32).  Returns 0, or 1 for a shape the kernel does not
// take or a lane count out of range, 2 when memory runs out.
extern "C" int aletsch_bridge_host(const int* P, const int* Wt,
                                   const int* Lv, const int* tgt, int n,
                                   int V, int E, int T, int sP, int sW,
                                   int sL, int sT, int* ostk, int* par,
                                   int* pix, unsigned long long* prof,
                                   int nt) {
    const Shape s{V, E, T};
    if (!shape_ok(s) || nt < 1 || nt > 32)
        return 1;
    char* buf = (char*)aligned_alloc(16, carve(nullptr, s, nullptr));
    if (!buf)
        return 2;
    Smem m;
    carve(buf, s, &m);
    const In in{P, Wt, Lv, tgt, sP, sW, sL, sT};
    const Out out{ostk, par, pix};
    team::run_team(nt, [&](Lanes& w) {
        unsigned long long acc[NPROF] = {};
        for (int b = 0; b < n; ++b) {
            if (prof)
                run_instance<true>(m, s, in, out, b, w, acc);
            else
                run_instance<false>(m, s, in, out, b, w, acc);
            // the next instance rewrites the tables just read out
            team::lanes_sync(w);
        }
        if (prof && w.tid == 0)
            for (int i = 0; i < NPROF; ++i)
                prof[i] += acc[i];
    });
    free(buf);
    return 0;
}

// The lanes' primitives on nt threads, for the tests; out[t] is what lane
// t got.  kind 0: team::lex_argmin over the lanes, lane t's has, six keys
// and position at in[8 t .. 8 t + 7]; 1: ballot of in[t] != 0; 2, 3:
// lanes_min, lanes_max of in[t]; 4: bcast of in[t] from lane in[nt].
// Returns 0, or 1 for a kind or lane count it does not take.
extern "C" int aletsch_bridge_lanes_host(int kind, int nt, const int* in,
                                         int* out) {
    if (kind < 0 || kind > 4 || nt < 1 || nt > 32)
        return 1;
    team::run_team(nt, [&](Lanes& w) {
        const int t = w.tid;
        int r = 0;
        if (kind == 0)
            r = team::lex_argmin<NKEY>(w, in[8 * t] != 0, in + 8 * t + 1,
                                       in[8 * t + 7]);
        else if (kind == 1)
            r = (int)team::ballot(w, in[t] != 0);
        else if (kind == 2)
            r = team::lanes_min(w, in[t]);
        else if (kind == 3)
            r = team::lanes_max(w, in[t]);
        else
            r = team::bcast(w, in[t], in[nt]);
        out[t] = r;
    });
    return 0;
}
