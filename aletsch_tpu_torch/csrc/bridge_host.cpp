// The bridge top-K kernel's per-instance machine (bridge_machine.cuh) built
// by a host compiler for one thread, instance after instance: the CPU
// tests hold it against the plain PyTorch form, the JAX package's program
// and the numpy oracle (tests/test_torch_bridge_kernel.py), so the
// transcription that bridge.cu runs on the card is exercised where no
// card is.  Same arguments as aletsch_bridge_topk, without the stream.
// Build:
//     g++ -std=c++17 -O2 -shared -fPIC -o libbridge_host.so bridge_host.cpp

#include <stdlib.h>

#include "bridge_machine.cuh"

using namespace bridge;

extern "C" int aletsch_bridge_host(const int* P, const int* Wt,
                                   const int* Lv, const int* tgt, int n,
                                   int V, int E, int T, int* ostk, int* par,
                                   int* pix) {
    const Shape s{V, E, T};
    if (!shape_ok(s))
        return 1;
    char* buf = (char*)malloc(carve(nullptr, s, nullptr) + 16);
    if (!buf)
        return 2;
    Smem m;
    carve(buf, s, &m);
    const In in{P, Wt, Lv, tgt};
    const Out out{ostk, par, pix};
    for (int b = 0; b < n; ++b)
        run_instance(m, s, in, out, b, 0, 1);
    free(buf);
    return 0;
}
