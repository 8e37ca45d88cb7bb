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
// vertex of the graph (core_scallop.h greedy_step_device).  A term with
// u >= v is min(NEG, W[u, v]) = NEG and T[v] starts at NEG, so
// T[v] = max(NEG, max over u < v of min(T[u], W[u, v])): that is what the
// kernel computes.  Only f32 min, max and compares run, and max is taken
// in another order than the plain version takes it, which changes nothing
// but the sign of a zero (min/max over {-0, +0} may return either; the
// consumer reads values only).  Build without --use_fast_math.
//
// The bound: bytes.  Only the entries with u < v can change T, so a graph
// at V = 64 needs 2,016 of its 4,096 entries, 8 KB, and writes 256 B once:
// ~0.0025 us at 3.35 TB/s (~0.16 us for 64 graphs), against ~4,000 min/max.
// What the kernel actually waits on is far above that bound: the latency
// of staging one graph, and the chain of V - 1 dependent steps (T[v] needs
// T[u] for every u < v).  On the step path a launch carries about 1.2
// graphs, so nothing hides either.
//
// What the design does about it ("push" form):
// - each lane owns destinations: lane l keeps the running best of v = l
//   and v = l + 32 in registers.  Step u broadcasts the now final T[u]
//   from its owner with one __shfl_sync, and every lane folds
//   min(T[u], W[u][v]) into its own best.  T[v] is final after step v - 1
//   because every edge has u < v.  No reduction is left: the chain a step
//   is one shuffle, one min and one max, where the pull form (gather
//   min(T[u], W[u, v]) over u, then a five-level shuffle butterfly) had
//   five dependent shuffle-and-max levels.  The loads of row u do not
//   depend on the chain and are issued ahead by the unrolled loop;
// - push form reads row u, contiguous in v, so shared memory keeps the
//   export's [u][v] layout: no transpose, no padded rows, conflict-free
//   reads.  Entries with v <= u (no edge of a topological order; the
//   reference ignores them too, see above), and columns past V, are set to
//   NEG on the way in, so the sweep needs no mask and lanes past V take no
//   part;
// - the whole block (8 warps) stages the graph, with 16-byte loads when
//   V = 64 (the shape every caller passes), every thread's loads in
//   flight together; then one warp runs the chain and the others exit at
//   the one barrier.  Plain loads, not cp.async: the form conversion and
//   the mask are applied in registers on the way to shared memory.
// One CTA per live graph, so a launch covers exactly the graphs the wave
// exported.  Batching rows across waves and CUDA graphs are host-side work
// for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXV = 64;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1.0e18f;
constexpr float POS = 1.0e18f;

// the value shared memory holds for W[u, v]
template <bool NEG_FORM>
__device__ __forceinline__ float staged(float w, int u, int v) {
    if (!NEG_FORM) w = w > 0.0f ? w : NEG;
    return v > u ? w : NEG;
}

template <bool NEG_FORM>
__global__ void __launch_bounds__(THREADS)
bottleneck_kernel(const float* __restrict__ W, int V, float* __restrict__ T) {
    __shared__ __align__(16) float Ws[MAXV * MAXV];  // Ws[u * MAXV + v]
    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const float* Wb = W + (size_t)b * V * V;

    // rows 0 .. V-2 are read as sources; row V-1 has no edge to push
    if (V == MAXV && (reinterpret_cast<uintptr_t>(Wb) & 15) == 0) {
        const float4* W4 = reinterpret_cast<const float4*>(Wb);
        float4* Ws4 = reinterpret_cast<float4*>(Ws);
        #pragma unroll
        for (int j = 0; j < MAXV * MAXV / 4 / THREADS; ++j) {
            const int i = tid + j * THREADS;
            const int u = i >> 4, v = (i & 15) << 2;
            float4 w = W4[i];
            w.x = staged<NEG_FORM>(w.x, u, v);
            w.y = staged<NEG_FORM>(w.y, u, v + 1);
            w.z = staged<NEG_FORM>(w.z, u, v + 2);
            w.w = staged<NEG_FORM>(w.w, u, v + 3);
            Ws4[i] = w;
        }
    } else {
        for (int u = warp; u < V - 1; u += THREADS / 32) {
            const float* row = Wb + (size_t)u * V;
            #pragma unroll
            for (int v = lane; v < MAXV; v += 32)
                Ws[u * MAXV + v] =
                    v < V ? staged<NEG_FORM>(row[v], u, v) : NEG;
        }
    }
    __syncthreads();
    if (warp != 0) return;

    float b0 = lane == 0 ? POS : NEG;   // best so far of v = lane; T[lane]
    float b1 = NEG;                     // the same for v = lane + 32
    const int last = V - 1;             // sources are u = 0 .. V-2
    const int half = last < 32 ? last : 32;
    #pragma unroll 8
    for (int u = 0; u < half; ++u) {
        const float tu = __shfl_sync(FULL, b0, u);
        b0 = fmaxf(b0, fminf(tu, Ws[u * MAXV + lane]));
        b1 = fmaxf(b1, fminf(tu, Ws[u * MAXV + lane + 32]));
    }
    // from u = 32 on, every v < 32 is final
    #pragma unroll 8
    for (int u = 32; u < last; ++u) {
        const float tu = __shfl_sync(FULL, b1, u - 32);
        b1 = fmaxf(b1, fminf(tu, Ws[u * MAXV + lane + 32]));
    }
    float* Tb = T + (size_t)b * V;
    if (lane < V) Tb[lane] = b0;
    if (lane + 32 < V) Tb[lane + 32] = b1;
}

template <bool NEG_FORM>
int launch(const void* W, int B, int V, void* T, void* stream) {
    if (B > 0) {
        bottleneck_kernel<NEG_FORM><<<B, THREADS, 0, (cudaStream_t)stream>>>(
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
