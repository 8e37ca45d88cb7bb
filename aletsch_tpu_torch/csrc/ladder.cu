// The scallop resolution ladder's prefix for Hopper (sm_90a): every staged
// graph runs from its initial state to PC_DONE, or to the iteration cap,
// in one launch, with no host read in between.
//
// Replaces the XLA program aletsch_tpu/ops/ladder_kernel.py::_build (the
// jitted lax.while_loop at :772), whose loop condition ran on the TPU.  Its
// semantics are those of the plain form beside this kernel,
// aletsch_tpu_torch/ops/ladder_kernel.py::ladder_plain (rungs 1-4 of
// ops/ladder_ref.py: resolve_broken_vertex, resolve_trivial_vertex_fast,
// resolve_trivial_vertex(1, fast), resolve_smallest_edges), and the
// kernel's 13 outputs and its per-graph event counts equal the plain
// form's bit for bit.
//
// One iteration is one event of one graph: a single arm fire, one pair of
// a trivial-vertex decomposition (PC_DECOMP) or an arm transition.  The
// plain form advances every graph of the batch by one event a step, in
// lockstep, but no graph reads another's state (the two batch-wide guards
// of the plain loop only skip tables no graph of that step reads), so
// here each graph runs to its own end, counts its own events and stops at
// maxiter; a graph still running then reads out as OVERFLOW, as finish()
// does.  The one difference the lockstep makes: the plain body adds +0.0
// to the root's first in- and out-edge weights of every graph on steps
// where it triggers nothing, which turns a -0.0 there into +0.0; here
// that add runs only where a decomposition starts.  So on -0.0 weights
// the final ewrt may differ in the sign of a zero, and nothing else
// differs (tests/test_torch_ladder_kernel.py holds this on states full of
// -0.0; ewrt does not leave DeviceLadder), and the native export stages
// none (tests/test_torch_e2e.py).
//
// Arithmetic: f64, transcribed operation for operation from the plain
// form.  Sums along an adjacency list run in list (stamp) order, one add
// at a time.  f64 sqrt and division are IEEE correctly rounded (nvcc's
// defaults for f64).  No product may contract into a fused multiply-add
// (the balance step w * r then w < guard, guard - w; the merge
// wx * 0.5 + wy * 0.5): this file is built with -fmad=false
// (ops/_build.py, SOURCE_FLAGS), and never with --use_fast_math.
//
// The bound: bytes.  A graph reads its edge table, hyper lists and scalars
// once (about 16 KB at V 64, E 256, H 64, L 32) and writes its log and
// final state once (about 15.5 KB), about 2 MB for 64 graphs, 0.6 us at
// 3.35 TB/s.  What the kernel really waits on is the serial chain of
// events of the longest graph of the launch (tens of events a dispatch on
// the production cohort), each a few dependent passes over the graph.
//
// Design (the per-graph machine is in ladder_machine.cuh, its block
// primitives in ladder_block.cuh; a host compiler builds both for the CPU
// tests, at one thread and at several):
// - one CTA of 256 threads per graph; the graph's whole state (edge table,
//   hyper lists, decision log, the pending decomposition's pairs) and the
//   per-event tables live in dynamic shared memory, sized from the shape
//   (69,764 bytes at the production shape);
// - an event builds only the tables its arm reads (none for a pair of a
//   decomposition, the degrees for the broken arm), and no pass runs an
//   O(E) or O(H L) loop on one thread: degrees by shared atomics over the
//   live edges, each edge landing in its vertex's bucket at the slot its
//   count gave it; each edge's rank in its vertex's stamp-ordered list
//   counted inside that bucket (the plain form's scatter-amax, ranks past
//   DMAX sharing the last slot, is an atomicMax); each list's ordered sum
//   and last-min-wins smallest edge on a thread of its own, lists and
//   hyper rows at odd pitches so that a warp's threads hit 32 banks; each
//   vertex's flags on a thread, the dominate and extend queries visiting
//   only their edge's occurrences in an index of the hyper lists (rebuilt
//   by a count, a block scan and a scatter where an arm that asks runs
//   after the lists changed); the arm's first candidate by a block-wide
//   minimum;
// - thread 0 applies the event, on its scalar state held in registers:
//   the order-dependent scans (later candidate wins on an equal ratio,
//   early break at ratio < jump_ratio) over the flagged vertices only, the
//   log append, the balance and the pairs of a decomposition over the
//   root's lists' lengths, one pair's split and merge and the capacity
//   checks (DLOG log slots, DMAX list length, E edge slots), with the same
//   results as the plain form, overflow included; the broken arm's pass
//   over the edges and the merged root's remaining degree then run on
//   every thread;
// - the event's hyper-list updates come last in every arm: the pair
//   replacement a row a warp (ballots place the kept entries), then the
//   single replacements and the removals an entry a thread.
// The profiling instance (aletsch_ladder_f64_prof, never on the main path)
// adds each pass's clock64() cycles to an output array (PERF.md, section 6,
// has the split before and after this design).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ladder_machine.cuh"

namespace {

using namespace ladder;

constexpr int THREADS = 256;
static_assert(THREADS % 32 == 0 && THREADS / 32 <= MAX_SLOTS,
              "a slot a warp");

template <bool PROF>
__global__ void __launch_bounds__(THREADS, 1)
ladder_kernel(In in, Out out, Shape s, int maxiter,
              unsigned long long* prof) {
    extern __shared__ __align__(16) char smem[];
    __shared__ Scal g;
    __shared__ Scratch x;
    __shared__ Prof pf;
    __shared__ int slots[2 * MAX_SLOTS];
    Smem m;
    carve(smem, s, &m);
    Blk b{(int)threadIdx.x, THREADS, slots, 0};
    if (PROF)
        for (int i = b.tid; i < NPROF; i += THREADS)
            pf.acc[i] = 0;
    load_graph(m, g, s, in, blockIdx.x, b);
    run_graph<PROF>(m, g, s, x, maxiter, b, &pf);
    store_graph(m, g, s, out, blockIdx.x, b);
    if (PROF)
        for (int i = b.tid; i < NPROF; i += THREADS)
            atomicAdd(prof + i, pf.acc[i]);
}
// Launch one instance of the kernel: cudaErrorInvalidValue for a shape
// the kernel does not take (DMAX > 256, or more shared memory than a block
// may have).
template <bool PROF>
int launch(const In& in, const Out& out, const Shape& s, int B, int maxiter,
           unsigned long long* prof, cudaStream_t stream) {
    if (!shape_ok(s))
        return cudaErrorInvalidValue;
    if (B <= 0)
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
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, ladder_kernel<PROF>);
    if (err != cudaSuccess)
        return err;
    if (bytes + attr.sharedSizeBytes > (size_t)limit)
        return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ladder_kernel<PROF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess)
        return err;
    ladder_kernel<PROF><<<B, THREADS, bytes, stream>>>(in, out, s, maxiter,
                                                        prof);
    return cudaGetLastError();
}

}  // namespace

// the C entries' inputs and outputs as the machine takes them: the
// per-graph strides of the 17 inputs (in elements) from the host array
// in_stride
#define LADDER_IN_OUT                                                       \
    In in{esrc, edst, ewrt, estr, esin, esout, ealive, nedges, nstamp, nz,  \
          hedge, hlen, nv, jump, smallr, guard, smin, {}};                  \
    for (int i = 0; i < 17; ++i)                                            \
        in.st[i] = in_stride[i];                                            \
    const Out out{larm, ltgt, ndec, status, ewrt_out, ealive_out,           \
                  esrc_out, edst_out, estr_out, nedges_out, hedge_out,      \
                  hlen_out, nz_out, events};

// Run the ladder prefix of B graphs on `stream`, one block a graph; graph
// b's row of input i starts b * in_stride[i] elements into it (each row
// contiguous), the outputs are dense, and an output whose pointer is null
// is not stored.  Returns the CUDA error (cudaErrorInvalidValue for a
// shape the kernel does not take: DMAX > 256, or more shared memory than a
// block may have).  No synchronisation.
extern "C" int aletsch_ladder_f64(
    const int* esrc, const int* edst, const double* ewrt, const int* estr,
    const int* esin, const int* esout, const uint8_t* ealive,
    const int* nedges, const int* nstamp, const uint8_t* nz,
    const int* hedge, const int* hlen, const int* nv, const double* jump,
    const double* smallr, const double* guard, const double* smin, int B,
    int V, int E, int H, int L, int DMAX, int DLOG, int maxiter, int* larm,
    int* ltgt, int* ndec, int* status, double* ewrt_out,
    uint8_t* ealive_out, int* esrc_out, int* edst_out, int* estr_out,
    int* nedges_out, int* hedge_out, int* hlen_out, uint8_t* nz_out,
    int* events, const long long* in_stride, cudaStream_t stream) {
    LADDER_IN_OUT
    return launch<false>(in, out, Shape{V, E, H, L, DMAX, DLOG}, B, maxiter,
                         nullptr, stream);
}

// aletsch_ladder_f64's profiling instance, never on the main path: the
// same results, and each pass's clock64() cycles added to prof (NPROF
// zeroed u64 on the card: cycles[pass][pc], then events[pc]).
extern "C" int aletsch_ladder_f64_prof(
    const int* esrc, const int* edst, const double* ewrt, const int* estr,
    const int* esin, const int* esout, const uint8_t* ealive,
    const int* nedges, const int* nstamp, const uint8_t* nz,
    const int* hedge, const int* hlen, const int* nv, const double* jump,
    const double* smallr, const double* guard, const double* smin, int B,
    int V, int E, int H, int L, int DMAX, int DLOG, int maxiter, int* larm,
    int* ltgt, int* ndec, int* status, double* ewrt_out,
    uint8_t* ealive_out, int* esrc_out, int* edst_out, int* estr_out,
    int* nedges_out, int* hedge_out, int* hlen_out, uint8_t* nz_out,
    int* events, const long long* in_stride, unsigned long long* prof,
    cudaStream_t stream) {
    LADDER_IN_OUT
    return launch<true>(in, out, Shape{V, E, H, L, DMAX, DLOG}, B, maxiter,
                        prof, stream);
}
