// Single-source bottleneck DP for Hopper (sm_90a): for each graph b of a
// [B, V, V] f32 batch in topological order, T[b, v] = the max over 0 -> v
// paths of the min edge weight, T[b, 0] = POS, NEG where v is unreachable.
//
// Replaces two TPU kernels of aletsch_tpu/ops/pallas_kernels.py:
// - #2, _kernel_tile_v2 (pallas_call at :112), in both of its forms: the
//   NEG form (NEG marks an absent edge, zero-weight edges are real), which
//   step-mode greedy runs once per extraction (get_greedy_pallas_fn, the
//   backend of ops/greedy_dp.py::DeviceGreedy), and the positive form
//   (W <= 0 is absent) of bottleneck_from_source_pallas(version=2);
// - #3, _kernel_tile (pallas_call at :61), bottleneck_from_source_pallas(
//   version=1), which computes the same T as #2's positive form.
// NEG_FORM = true is the first instance, NEG_FORM = false the positive
// form of #2 and all of #3.  Left behind as TPU workarounds: the
// pre-transposed WT input (:111), v1's lane-mask column select (the TPU
// bans dynamic lane indexing) and the 8- and 16-graph tiles.  The kernel
// reads the native export's W[b, u, v] as it is.
//
// Semantics, as greedy_dp.single_source_host and the Pallas bodies: for
// v = 1 .. V-1 in order, best = max over ALL u < V of min(T[u], W[u, v])
// (T[u] is still NEG for u >= v), then T[v] = max(T[v], best).  Every v
// runs: step mode has no sink, and the native consumer reads T for every
// vertex of the graph (core_scallop.h greedy_step_device).  Only f32
// min, max and compares run, so the result equals the plain version's bit
// for bit up to the sign of a zero (min/max over {-0, +0} may return
// either; the consumer reads values only).  Build without
// --use_fast_math.
//
// What bounds it on this card: latency and launch cost, not bytes or
// FLOPs.  A graph is V - 1 dependent steps, each a 64-wide max-reduction,
// over 16 KB of input; on the step path a launch carries about 1.2 graphs
// (one per paused graph of the wave that extracts next), so the card is
// nearly idle and the launch itself is most of the cost.
//
// What the design does about it: one warp (one CTA) per live graph, so a
// launch covers exactly the graphs the wave exported; the graph's W sits
// transposed in shared memory (Ws[v][u], rows padded to 65 floats so both
// the staging stores and the per-step row reads are free of bank
// conflicts); lane u holds T[u] and T[u + 32] in registers; each step is
// two min, one max and a five-level __shfl_xor_sync max butterfly, with no
// block barrier; the row is written coalesced at the end.  Batching rows
// across waves, CUDA graphs and several graphs per CTA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXV = 64;
constexpr int LD = MAXV + 1;        // padded row of Ws
constexpr unsigned FULL = 0xffffffffu;

template <bool NEG_FORM>
__global__ void __launch_bounds__(32)
bottleneck_kernel(const float* __restrict__ W, int V, float* __restrict__ T) {
    __shared__ float Ws[MAXV * LD];     // Ws[v * LD + u] = W[b, u, v]
    const int b = blockIdx.x;
    const int lane = threadIdx.x;
    const float NEG = -1.0e18f;
    const float POS = 1.0e18f;
    const float* Wb = W + (size_t)b * V * V;

    // coalesced reads of W[b] (16 KB at V = 64), several loads in flight
    #pragma unroll 8
    for (int i = lane; i < V * V; i += 32) {
        const int u = i / V, v = i - u * V;
        float w = Wb[i];
        if (!NEG_FORM) w = w > 0.0f ? w : NEG;
        Ws[v * LD + u] = w;
    }
    __syncwarp();

    float t0 = lane == 0 ? POS : NEG;   // T[lane]
    float t1 = NEG;                     // T[lane + 32]
    for (int v = 1; v < V; ++v) {
        const float* row = Ws + v * LD;
        // lanes past V take no part: -inf is the identity of max
        float c = lane < V ? fminf(t0, row[lane]) : -INFINITY;
        if (lane + 32 < V) c = fmaxf(c, fminf(t1, row[lane + 32]));
        #pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            c = fmaxf(c, __shfl_xor_sync(FULL, c, off));
        if ((v & 31) == lane) {
            if (v < 32) t0 = fmaxf(t0, c); else t1 = fmaxf(t1, c);
        }
    }
    float* Tb = T + (size_t)b * V;
    if (lane < V) Tb[lane] = t0;
    if (lane + 32 < V) Tb[lane + 32] = t1;
}

template <bool NEG_FORM>
int launch(const void* W, int B, int V, void* T, void* stream) {
    if (B > 0) {
        bottleneck_kernel<NEG_FORM><<<B, 32, 0, (cudaStream_t)stream>>>(
            (const float*)W, V, (float*)T);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// W [B, V, V] f32, T [B, V] f32, 1 <= V <= 64 (the caller checks).
extern "C" int aletsch_bottleneck_neg(const void* W, int B, int V, void* T,
                                      void* stream) {
    return launch<true>(W, B, V, T, stream);
}

extern "C" int aletsch_bottleneck_pos(const void* W, int B, int V, void* T,
                                      void* stream) {
    return launch<false>(W, B, V, T, stream);
}
