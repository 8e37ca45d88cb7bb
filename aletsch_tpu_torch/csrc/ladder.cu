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
// Design (a simple first form, not tuned; the per-graph machine is in
// ladder_machine.cuh, which a host compiler also builds for the CPU tests):
// - one CTA of 256 threads per graph; the graph's whole state (edge table,
//   hyper lists, decision log, the pending decomposition's pairs) and the
//   per-event tables (per-vertex in/out lists in stamp order, degrees,
//   ordered sums, smallest edges, candidate flags) live in dynamic shared
//   memory, sized from the shape (40,576 bytes at the production shape,
//   beside ~4 KB of static shared memory);
// - per event the block rebuilds the tables in parallel: each edge finds
//   its rank in its vertex's list (a count over the edges, then an
//   atomicMax into the list slot, as the plain form's scatter-amax keeps
//   the larger edge id where ranks collide past DMAX); each vertex takes
//   its ordered sums in list order, its smallest edges (last minimum
//   wins) and its candidate predicates, including the hyper-list
//   dominate and extend queries, computed only where the arm that runs
//   reads them;
// - thread 0 then applies the event: the sequential vertex scans of the
//   arm (later candidate wins on an equal ratio, early break at
//   ratio < jump_ratio), the log append, the balance and the pairs of a
//   decomposition, one pair's split and merge and the capacity checks
//   (DLOG log slots, DMAX list length, E edge slots), with the same
//   results as the plain form, overflow included;
// - the event's hyper-list updates (replace a pair, replace a single,
//   remove edges) come last in every arm, and each row of the hyper lists
//   is independent, so the block applies them a row a thread after the
//   event (left to thread 0, they made a dispatch twice as long:
//   PERF.md, section 6).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ladder_machine.cuh"

namespace {

using namespace ladder;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
ladder_kernel(In in, Out out, Shape s, int maxiter) {
    extern __shared__ __align__(16) char smem[];
    __shared__ Scal g;
    __shared__ Scratch x;
    Smem m;
    carve(smem, s, &m);
    const int b = blockIdx.x, tid = threadIdx.x;
    load_graph(m, g, s, in, b, tid, THREADS);
    run_graph(m, g, s, x, maxiter, tid, THREADS);
    store_graph(m, g, s, out, b, tid, THREADS);
}

}  // namespace

// Run the ladder prefix of B graphs on `stream`, one block a graph;
// returns the CUDA error (cudaErrorInvalidValue for a shape the kernel does
// not take: DMAX > 256, or more shared memory than a block may have).  No
// synchronisation.
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
    int* events, cudaStream_t stream) {
    const Shape s{V, E, H, L, DMAX, DLOG};
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
    err = cudaFuncGetAttributes(&attr, ladder_kernel);
    if (err != cudaSuccess)
        return err;
    if (bytes + attr.sharedSizeBytes > (size_t)limit)
        return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ladder_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess)
        return err;
    const In in{esrc, edst, ewrt, estr, esin, esout, ealive, nedges,
                nstamp, nz, hedge, hlen, nv, jump, smallr, guard, smin};
    const Out out{larm, ltgt, ndec, status, ewrt_out, ealive_out,
                  esrc_out, edst_out, estr_out, nedges_out, hedge_out,
                  hlen_out, nz_out, events};
    ladder_kernel<<<B, THREADS, bytes, stream>>>(in, out, s, maxiter);
    return cudaGetLastError();
}
