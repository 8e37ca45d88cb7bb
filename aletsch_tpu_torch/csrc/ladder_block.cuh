// The block primitives of the ladder kernel's machine (ladder_machine.cuh):
// the barrier, the atomics, a block-wide minimum (find-first), OR and AND,
// and a block-wide exclusive scan.  Every thread of the block calls each
// collective primitive, in the same order.
//
// Two forms.  On the card (nvcc) a block is THREADS threads, a multiple of
// 32: warp shuffles and reductions inside a warp, one slot a warp in shared
// memory across warps, __syncthreads and its OR/AND forms.  On the host
// (ladder_host.cpp) a block is a team of nt std::threads (team.cuh: one
// slot a thread in shared memory under a std::barrier, C++20), with
// std::atomic_ref for the atomics, so the CPU tests run the machine's
// parallel passes with real concurrency (tests/test_torch_ladder_threads.py
// holds each primitive to its serial form).

#pragma once

#include <stdint.h>

#include "team.cuh"

#ifdef __CUDACC__
#define LADDER_HD __host__ __device__ inline
#define LADDER_FN __device__ inline
#define LADDER_CLOCK() ((unsigned long long)clock64())
#else
#include <atomic>
#define LADDER_HD inline
#define LADDER_FN inline
#define LADDER_CLOCK() 0ull
#endif

namespace ladder {

// the slots a block's reductions take in shared memory: two sets (the
// primitives alternate, so a set is written again only after every thread
// has passed the barrier behind the reads of its last use) of one a warp
// on the card (MAX_SLOTS a set), one a thread on the host (nt a set)
constexpr int MAX_SLOTS = 64;

#ifdef __CUDACC__

struct Blk {
    int tid, nt;
    int* slots;     // 2 * MAX_SLOTS ints of shared memory
    int par;        // which set of slots the next reduction writes

    __device__ void sync() const { __syncthreads(); }
};

LADDER_FN int atomic_add(int* p, int v) { return atomicAdd(p, v); }
LADDER_FN int atomic_sub(int* p, int v) { return atomicSub(p, v); }
LADDER_FN void atomic_max(int* p, int v) { atomicMax(p, v); }
LADDER_FN void atomic_max(unsigned long long* p, unsigned long long v) {
    atomicMax(p, v);
}

// the set of slots the next reduction writes
LADDER_FN int* next_slots(Blk& b) {
    int* sl = b.slots + b.par * MAX_SLOTS;
    b.par ^= 1;
    return sl;
}

// min over the block of each thread's x; ends with a barrier
LADDER_FN int blk_min(Blk& b, int x) {
    const int w = __reduce_min_sync(0xffffffffu, x);
    int* sl = next_slots(b);
    if ((b.tid & 31) == 0)
        sl[b.tid >> 5] = w;
    __syncthreads();
    int r = sl[0];
    for (int i = 1; i < (b.nt >> 5); ++i)
        r = sl[i] < r ? sl[i] : r;
    return r;
}

LADDER_FN bool blk_or(Blk&, bool p) { return __syncthreads_or(p) != 0; }
LADDER_FN bool blk_and(Blk&, bool p) { return __syncthreads_and(p) != 0; }

// inclusive sum of x over the lanes of a warp up to this one
LADDER_FN int warp_incl(int x) {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d)
            x += y;
    }
    return x;
}

#else

// a team of nt host threads (team.cuh), its slots 2 * nt ints
using Blk = team::Team;

inline int atomic_add(int* p, int v) {
    return std::atomic_ref<int>(*p).fetch_add(v, std::memory_order_relaxed);
}
inline int atomic_sub(int* p, int v) {
    return std::atomic_ref<int>(*p).fetch_sub(v, std::memory_order_relaxed);
}
template <class T>
inline void atomic_max(T* p, T v) {
    std::atomic_ref<T> a(*p);
    T cur = a.load(std::memory_order_relaxed);
    while (cur < v
           && !a.compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
    }
}

using team::next_slots;

template <class F>
inline int blk_fold(Blk& b, int x, F f) {
    return team::fold(b, x, f);
}

inline int blk_min(Blk& b, int x) {
    return blk_fold(b, x, [](int a, int c) { return c < a ? c : a; });
}
inline bool blk_or(Blk& b, bool p) {
    return blk_fold(b, p, [](int a, int c) { return a | c; }) != 0;
}
inline bool blk_and(Blk& b, bool p) {
    return blk_fold(b, p, [](int a, int c) { return a & c; }) != 0;
}

#endif

// Exclusive scan of a[0, n) into out[0, n), and the total into out[n]:
// each thread sums a run of ceil(n / nt) items, the runs' sums are scanned
// across the block (within a warp by shuffles on the card, then over the
// warps' slots; over the threads' slots on the host), and each thread
// writes its run.  a and out may not overlap.  Ends with a barrier.
LADDER_FN void blk_scan(Blk& b, const int* a, int* out, int n) {
    const int per = (n + b.nt - 1) / b.nt;
    const int lo = b.tid * per < n ? b.tid * per : n;
    const int hi = lo + per < n ? lo + per : n;
    int s = 0;
    for (int i = lo; i < hi; ++i)
        s += a[i];
    int* sl = next_slots(b);
#ifdef __CUDACC__
    const int incl = warp_incl(s);
    const int w = b.tid >> 5;
    if ((b.tid & 31) == 31)
        sl[w] = incl;
    __syncthreads();
    int run = incl - s;
    for (int i = 0; i < w; ++i)
        run += sl[i];
#else
    sl[b.tid] = s;
    b.sync();
    int run = 0;
    for (int i = 0; i < b.tid; ++i)
        run += sl[i];
#endif
    for (int i = lo; i < hi; ++i) {
        out[i] = run;
        run += a[i];
    }
    if (b.tid == b.nt - 1)
        out[n] = run;
    b.sync();
}

}  // namespace ladder
