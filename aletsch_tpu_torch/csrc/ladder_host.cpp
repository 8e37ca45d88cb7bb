// The ladder kernel's per-graph machine (ladder_machine.cuh) built by a host
// compiler for one thread, graph after graph: the CPU tests hold it against
// the plain PyTorch form (tests/test_torch_ladder_kernel.py), so the
// transcription that ladder.cu runs on the card is exercised where no card
// is.  Same arguments as aletsch_ladder_f64, without the stream.  Build:
//     g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC
//         -o libladder_host.so ladder_host.cpp
// (-ffp-contract=off: no fused multiply-add, as nvcc -fmad=false).

#include <stdint.h>
#include <stdlib.h>

#include "ladder_machine.cuh"

using namespace ladder;

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
    int* events) {
    const Shape s{V, E, H, L, DMAX, DLOG};
    if (!shape_ok(s))
        return 1;
    char* buf = (char*)malloc(carve(nullptr, s, nullptr) + 16);
    if (!buf)
        return 2;
    Smem m;
    carve(buf, s, &m);
    Scal g;
    Scratch x;
    const In in{esrc, edst, ewrt, estr, esin, esout, ealive, nedges,
                nstamp, nz, hedge, hlen, nv, jump, smallr, guard, smin};
    const Out out{larm, ltgt, ndec, status, ewrt_out, ealive_out,
                  esrc_out, edst_out, estr_out, nedges_out, hedge_out,
                  hlen_out, nz_out, events};
    for (int b = 0; b < B; ++b) {
        load_graph(m, g, s, in, b, 0, 1);
        run_graph(m, g, s, x, maxiter, 0, 1);
        store_graph(m, g, s, out, b, 0, 1);
    }
    free(buf);
    return 0;
}
