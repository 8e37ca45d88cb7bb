// The bridge top-K DP for Hopper (sm_90a): every pier-DP instance of a
// dispatch from its inputs to its tables in one launch, one warp an
// instance.
//
// Replaces the XLA program aletsch_tpu/ops/bridge_topk.py::_build (the
// jitted lax.fori_loop at :131 over lax.sort at :106).  Its semantics are
// those of the plain form beside this kernel,
// aletsch_tpu_torch/ops/bridge_topk.py::bridge_plain: for each vertex k =
// 1..V-1 of a topo-ordered window, the candidates (in-edge slot e, entry i
// of the slot's predecessor) at position e K + i take the predecessor's
// ascending min-edge stack with the edge weight inserted and its length
// plus Lv[k]; the first K in the stable order of the six i32 keys
// (-stack[0..4], length), ties by position, become vertex k's entries.
// The three outputs (the stacks at the targets, the parent and entry
// tables) equal the plain form's bit for bit.  P values outside [-1, V)
// and targets outside [-1, V) count as absent (the plain form refuses
// them).
//
// The bound: bytes.  A dispatch reads P and Wt (2 V E i32 a row), Lv and
// tgt and writes ostk, par and pix (T K S + 2 V K i32 a row): about 17 KB
// a row at the production shape (V 64, E 16, T 16), 1.1 MB for 64 rows,
// 0.3 us at 3.35 TB/s.  What the kernel waits on is each instance's chain
// of dependent steps: a dispatch holds 1 to 64 instances (36.5 on the
// production cohort), far fewer than the card's 132 SMs could run side by
// side, so the time of one instance's chain is the kernel's.
//
// Design (the per-instance machine is in bridge_machine.cuh over
// team.cuh, which a host compiler also builds for the CPU tests):
// - one warp an instance, up to WARPS instances a block (fewer where their
//   shared memory would pass the block's limit; the kernel's attribute is
//   raised to that limit once a device), no block barrier: a step
//   takes __syncwarp and the warp's vote, reduction and shuffle
//   instructions only.  An instance's inputs and tables sit in dynamic
//   shared memory (28,656 bytes at the production shape, 114,624 for a
//   block of four): P, Wt, Lv and tgt, read from device memory once (P
//   and Wt by cp.async in 16-byte pieces where aligned); the stacks and
//   lengths [V, K, S], [V, K]; a vertex's valid entries as the bits of one
//   word; the step's valid candidates' keys by position.  The outputs
//   are set to -1 in device memory first; a step writes its valid
//   entries' rows of the parent and entry tables there, and the end the
//   stacks of the targets' valid entries;
// - a step first reads its in-edge row: with no live predecessor entry
//   the step is closed form (its entries stay invalid), and the steps
//   after the last vertex with a live in-edge are not run at all;
// - otherwise each lane builds the valid candidates at its positions (c =
//   lane, lane + 32, ... below the row's last live slot, K positions a
//   slot), a ballot counting the valid ones ahead by position, and keeps
//   the first of its own in the order (its head) in registers;
// - selection, not ranking: the first K of the step in up to K rounds, a
//   round the least head over the lanes (team::lex_argmin: the warp's
//   minimum of one key among the lanes still tied, then a ballot of those
//   that hold it, key by key, the position last), the winner noting its
//   position against the entry and rescanning its own candidates (at
//   most E K / 32) for its next head.  The rounds stop after the valid candidates; the
//   entries that absent candidates fill stay invalid (their rows are the
//   same whichever absent candidate fills them);
// - then a lane an entry writes vertex k's entries.
// The profiling instance (aletsch_bridge_topk_prof, never on the main path)
// adds each pass's clock64() cycles and the step counts to an output array
// (PERF.md, section 6, has the split before and after this design).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bridge_machine.cuh"

namespace {

using namespace bridge;

// instances (warps) a block at most
constexpr int WARPS = 4;

template <bool PROF>
__global__ void __launch_bounds__(32 * WARPS)
bridge_kernel(In in, Out out, Shape s, int n, int inst_bytes,
              unsigned long long* prof) {
    extern __shared__ __align__(16) char smem[];
    const int warp = threadIdx.x >> 5;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= n)
        return;
    Smem m;
    carve(smem + (size_t)warp * inst_bytes, s, &m);
    Lanes w{(int)(threadIdx.x & 31), 32};
    unsigned long long acc[NPROF] = {};
    run_instance<PROF>(m, s, in, out, b, w, acc);
    if (PROF && w.tid == 0)
        for (int i = 0; i < NPROF; ++i)
            atomicAdd(prof + i, acc[i]);
}

// the most devices whose limit smem_limit keeps
constexpr int MAX_DEVICES = 64;

// The opt-in shared memory limit of a block on device dev, into *limit;
// on a device's first call the kernel's dynamic shared memory attribute
// is raised to it, so that a launch itself makes no attribute call.
template <bool PROF>
cudaError_t smem_limit(int dev, int* limit) {
    static std::atomic<int> known[MAX_DEVICES];
    const bool keep = dev >= 0 && dev < MAX_DEVICES;
    if (keep && (*limit = known[dev].load(std::memory_order_relaxed)) > 0)
        return cudaSuccess;
    cudaError_t err = cudaDeviceGetAttribute(
        limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess)
        return err;
    err = cudaFuncSetAttribute(bridge_kernel<PROF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *limit);
    if (err == cudaSuccess && keep)
        known[dev].store(*limit, std::memory_order_relaxed);
    return err;
}

template <bool PROF>
int launch(const In& in, const Out& out, const Shape& s, int n,
           unsigned long long* prof, cudaStream_t stream) {
    if (!shape_ok(s))
        return cudaErrorInvalidValue;
    if (n <= 0)
        return cudaSuccess;
    const size_t bytes = carve(nullptr, s, nullptr);
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return err;
    err = smem_limit<PROF>(dev, &limit);
    if (err != cudaSuccess)
        return err;
    if (bytes > (size_t)limit)
        return cudaErrorInvalidValue;
    int warps = (int)((size_t)limit / bytes);
    warps = warps < WARPS ? warps : WARPS;
    warps = warps < n ? warps : n;
    const int blocks = (n + warps - 1) / warps;
    bridge_kernel<PROF><<<blocks, 32 * warps, warps * bytes, stream>>>(
        in, out, s, n, (int)bytes, prof);
    return cudaGetLastError();
}

}  // namespace

// The top-K DP of n instances on `stream`, one warp an instance; row b of
// input x starts b * s<x> elements into it (each row contiguous), the
// outputs are dense.  Returns the CUDA error (cudaErrorInvalidValue for a
// shape the kernel does not take: V < 1, E < 1, T < 0, or more shared
// memory than a block may have).  n = 0 launches nothing.  No
// synchronisation.
extern "C" int aletsch_bridge_topk(const int* P, const int* Wt, const int* Lv,
                                   const int* tgt, int n, int V, int E,
                                   int T, int sP, int sW, int sL, int sT,
                                   int* ostk, int* par, int* pix,
                                   cudaStream_t stream) {
    return launch<false>(In{P, Wt, Lv, tgt, sP, sW, sL, sT},
                         Out{ostk, par, pix}, Shape{V, E, T}, n, nullptr,
                         stream);
}

// aletsch_bridge_topk's profiling instance, never on the main path: the
// same results, and each pass's clock64() cycles and the counts added to
// prof (NPROF zeroed u64 on the card, bridge_machine.cuh).
extern "C" int aletsch_bridge_topk_prof(const int* P, const int* Wt,
                                        const int* Lv, const int* tgt, int n,
                                        int V, int E, int T, int sP, int sW,
                                        int sL, int sT, int* ostk, int* par,
                                        int* pix, unsigned long long* prof,
                                        cudaStream_t stream) {
    return launch<true>(In{P, Wt, Lv, tgt, sP, sW, sL, sT},
                        Out{ostk, par, pix}, Shape{V, E, T}, n, prof,
                        stream);
}
