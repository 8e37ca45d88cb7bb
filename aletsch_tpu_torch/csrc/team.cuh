// The collective primitives the kernels' machines share (ladder_block.cuh
// builds the ladder's block primitives on them, bridge_machine.cuh the
// bridge's warp): a team of nt threads that run the same code and meet at
// barriers.
//
// On the card (nvcc) the bridge's team is one warp: Lanes' primitives are
// the warp's vote, reduction and shuffle instructions (__ballot_sync,
// __reduce_min_sync, __shfl_sync, __syncwarp), with no shared memory and no
// __syncthreads.  On the host (ladder_host.cpp, bridge_host.cpp) a team is
// nt std::threads under a std::barrier (C++20), each with a slot in shared
// memory: a primitive writes the thread's value to its slot, passes the
// barrier, and folds every slot.  The slots come in two sets that the
// primitives alternate, so a set is written again only after every thread
// has passed the barrier behind the reads of its last use.  The CPU tests
// run both machines on such teams and hold each primitive to its serial
// form (tests/test_torch_ladder_threads.py, test_torch_bridge_threads.py).

#pragma once

#include <limits.h>
#include <stdint.h>

#ifdef __CUDACC__
#define TEAM_FN __device__ inline
#define TEAM_UNROLL _Pragma("unroll")
#else
#include <barrier>
#include <thread>
#include <vector>
#define TEAM_FN inline
#define TEAM_UNROLL
#endif

namespace team {

#ifndef __CUDACC__

// A team on the host: thread tid of nt, its slots 2 * nt ints.
struct Team {
    int tid, nt;
    int* slots;
    int par;        // which set of slots the next primitive writes
    std::barrier<>* bar;

    void sync() const { bar->arrive_and_wait(); }
};

// the set of slots the next primitive writes
inline int* next_slots(Team& b) {
    int* sl = b.slots + b.par * b.nt;
    b.par ^= 1;
    return sl;
}

// each thread's x in its slot; after the barrier every thread folds them
// in thread order
template <class F>
inline int fold(Team& b, int x, F f) {
    int* sl = next_slots(b);
    sl[b.tid] = x;
    b.sync();
    int r = sl[0];
    for (int i = 1; i < b.nt; ++i)
        r = f(r, sl[i]);
    return r;
}

// Run fn(Team&) on a team of nt threads (the caller's thread is thread 0).
template <class F>
void run_team(int nt, F fn) {
    std::barrier<> bar(nt);
    std::vector<int> slots(2 * (size_t)nt);
    auto body = [&](int tid) {
        Team b{tid, nt, slots.data(), 0, &bar};
        fn(b);
    };
    std::vector<std::thread> th;
    for (int t = 1; t < nt; ++t)
        th.emplace_back(body, t);
    body(0);
    for (auto& t : th)
        t.join();
}

#endif

// ------------------------------------------------ a warp's lanes

#ifdef __CUDACC__

// One warp: lane tid of nt = 32.
struct Lanes {
    int tid, nt;
};

TEAM_FN void lanes_sync(Lanes&) { __syncwarp(); }
// bit t set where lane t's p holds
TEAM_FN unsigned ballot(Lanes&, bool p) { return __ballot_sync(~0u, p); }
TEAM_FN int lanes_min(Lanes&, int x) { return __reduce_min_sync(~0u, x); }
TEAM_FN int lanes_max(Lanes&, int x) { return __reduce_max_sync(~0u, x); }
// lane src's x
TEAM_FN int bcast(Lanes&, int x, int src) { return __shfl_sync(~0u, x, src); }
TEAM_FN int lowest_bit(unsigned x) { return __ffs(x) - 1; }
TEAM_FN int bit_count(unsigned x) { return __popc(x); }

#else

// A team of nt <= 32 host threads standing in for a warp's lanes.
using Lanes = Team;

inline void lanes_sync(Lanes& b) { b.sync(); }
inline unsigned ballot(Lanes& b, bool p) {
    return (unsigned)fold(b, p ? (int)(1u << b.tid) : 0,
                          [](int a, int c) { return a | c; });
}
inline int lanes_min(Lanes& b, int x) {
    return fold(b, x, [](int a, int c) { return c < a ? c : a; });
}
inline int lanes_max(Lanes& b, int x) {
    return fold(b, x, [](int a, int c) { return c > a ? c : a; });
}
inline int bcast(Lanes& b, int x, int src) {
    int* sl = next_slots(b);
    sl[b.tid] = x;
    b.sync();
    return sl[src];
}
inline int lowest_bit(unsigned x) { return x ? __builtin_ctz(x) : -1; }
inline int bit_count(unsigned x) { return __builtin_popcount(x); }

#endif

// The lane whose tuple (key[0], ..., key[NK - 1], pos) comes first in
// lexicographic order among the lanes where has holds, or -1 where none
// does; the lanes that have must hold different pos.  The same on every
// lane.  One key at a time: the least key among the lanes still tied,
// then the lanes that hold it, until one lane is left; the position
// decides a tie on every key.
template <int NK>
TEAM_FN int lex_argmin(Lanes& w, bool has, const int* key, int pos) {
    bool me = has;
    unsigned in = ballot(w, me);
    TEAM_UNROLL
    for (int j = 0; j <= NK; ++j) {
        if ((in & (in - 1)) == 0)
            break;
        const int x = j < NK ? key[j] : pos;
        const int mn = lanes_min(w, me ? x : INT_MAX);
        me = me && x == mn;
        in = ballot(w, me);
    }
    return lowest_bit(in);
}

}  // namespace team
