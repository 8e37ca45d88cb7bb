// The bridge top-K DP for Hopper (sm_90a): every pier-DP instance of a
// dispatch from its inputs to its tables in one launch, one block an
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
// 0.3 us at 3.35 TB/s.  What the kernel really waits on is the chain of V
// - 1 dependent steps of each block, a gather and a rank pass each.
//
// Design (a simple form, not tuned; the per-instance machine is in
// bridge_machine.cuh, which a host compiler also builds for the CPU
// tests):
// - one block of 160 threads an instance (one thread a candidate at the
//   production in-degree E = 16), its inputs and tables in dynamic shared
//   memory: P, Wt and Lv, read from device memory once; the stacks [V, K,
//   S], lengths and valid flags [V, K]; the step's valid candidates'
//   keys [S + 1, E K] by slot (29,576 bytes at the production shape);
//   par and pix go straight to device memory;
// - per step, each thread builds its candidate (a gather of S stack
//   values, the insertion count, S + 1 keys) and, when it is valid, takes
//   the next slot with an atomic (the slots' order does not matter) and
//   writes its keys there; after a barrier each candidate counts the valid
//   ones ahead of it in the order, a slot at a time, the first key before
//   the rest, stopping at K, and adds the absent ones ahead of it in
//   closed form (they all share the keys (BIG, ..., BIG)); the candidate
//   whose count is r < K writes slot r.  The XLA form's three i64 sorts
//   over all E K candidates, with their broadcast index operands, are
//   gone;
// - after the last step the stacks are read out at the targets.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bridge_machine.cuh"

namespace {

using namespace bridge;

constexpr int THREADS = 16 * K;

__global__ void __launch_bounds__(THREADS)
bridge_kernel(In in, Out out, Shape s) {
    extern __shared__ __align__(16) char smem[];
    Smem m;
    carve(smem, s, &m);
    run_instance(m, s, in, out, blockIdx.x, threadIdx.x, THREADS);
}

}  // namespace

// The top-K DP of n instances on `stream`, one block an instance; returns
// the CUDA error (cudaErrorInvalidValue for a shape the kernel does not
// take: V < 1, E < 1, T < 0, or more shared memory than a block may have).
// n = 0 launches nothing.  No synchronisation.
extern "C" int aletsch_bridge_topk(const int* P, const int* Wt, const int* Lv,
                                   const int* tgt, int n, int V, int E,
                                   int T, int* ostk, int* par, int* pix,
                                   cudaStream_t stream) {
    const Shape s{V, E, T};
    if (!shape_ok(s))
        return cudaErrorInvalidValue;
    if (n <= 0)
        return cudaSuccess;
    const size_t bytes = carve(nullptr, s, nullptr);
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess)
        return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err != cudaSuccess)
        return err;
    if (bytes > (size_t)limit)
        return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(bridge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess)
        return err;
    const In in{P, Wt, Lv, tgt};
    const Out out{ostk, par, pix};
    bridge_kernel<<<n, THREADS, bytes, stream>>>(in, out, s);
    return cudaGetLastError();
}
