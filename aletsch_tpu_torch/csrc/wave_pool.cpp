// The wave pool of the device waves (meta/device_wave.py): one pool of
// native threads a process, made on first use and grown to the widest
// call, that advances the paused group runs of a device wave together.
// Each task is the serial path's own call of the native core
// (native/core.cpp) on one run, reached through the entry points that
// wave_bind hands in, so this library links nothing of the core and the
// core's source is unchanged.  Runs are independent (a GroupRun touches
// only its own state; the core's one shared static, the ladder histogram,
// is atomic), so the bytes do not depend on the thread that ran a task.
//
// A resume batch (wave_consume_fused, wave_greedy_step,
// wave_ladder_consume, wave_support_step, wave_bridge_feed) returns when
// every task has run, its caller running tasks too; a start batch
// (wave_start_async) returns at once, and wave_join runs what no worker
// has taken yet, then waits for the rest.  A batch of one, or any batch at
// width 0, runs on the calling thread alone.  Workers take resume batches
// first: their caller is waiting.  Counters a consume writes get one slot a
// task (stats2n: 2 x n).  Every call returns 0, or -1 when a task threw.
// wave_task_ns is the seconds, in ns, that tasks took on every thread.
// Build:
//     g++ -std=c++14 -O2 -pthread -shared -fPIC -o libwave_pool.so
//         wave_pool.cpp

#include <stdint.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

typedef int32_t i32;
typedef int64_t i64;

namespace {

// the native core's entry points, in wave_bind's order
struct Core {
    void* (*group_start)(
        i32 n_bundles, i32 do_bridge, const i32* nh,
        const i32* const* fixed_p, const i32* const* coords_p,
        const i32* const* mev_p, const i64* mev_cnt,
        const i32* const* iev_p, const i64* iev_cnt,
        const i32* const* frg_p, const i64* frg_cnt,
        const i32* sample_id, const i32* strand, const i64* lpos,
        const i64* rpos, const i64* ins_low, const i64* ins_high,
        const i64* cfg_ints, const double* cfg_dbls, i32 device_minv,
        i32 device_bridge, i32 device_support);
    void (*group_set_ladder)(void* h, i32 on);
    i32 (*group_advance)(void* h);
    i32 (*greedy_consume_fused)(void* h, const double* ws,
                                const uint8_t* paths, i32 npaths, i32 maxv,
                                i32 mode, i64* stats2);
    i32 (*greedy_step)(void* h, const float* table);
    i32 (*ladder_consume)(void* h, const i32* arm, const i32* tgt, i32 ndec,
                          i32 status, i32 mode, i64* stats2);
    i32 (*support_step)(void* h, const float* sums);
    i32 (*bridge_step)(void* h, const i32* ostk, const i32* par,
                       const i32* pix, i32 V, i32 T, i32 K, i32 S);
};

Core core;
std::atomic<i64> task_ns{0};

struct WaveBatch {
    std::function<void(i32)> task;
    i32 n = 0;
    i32 cap = 0;                        // most pool workers that join
    std::atomic<i32> next{0};
    std::atomic<i32> joined{0};
    std::atomic<bool> failed{false};
    std::mutex mu;
    std::condition_variable cv;
    i32 done = 0;                       // under mu

    void run() {
        for (;;) {
            i32 i = next.fetch_add(1);
            if (i >= n) return;
            auto t0 = std::chrono::steady_clock::now();
            try {
                task(i);
            } catch (...) {
                failed.store(true);
            }
            task_ns.fetch_add(std::chrono::duration_cast<
                std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0).count());
            std::lock_guard<std::mutex> lk(mu);
            if (++done == n) cv.notify_all();
        }
    }

    void wait() {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return done == n; });
    }
};

// workers wait on heap-allocated sync objects that are never destroyed, so
// no worker outlives what it waits on at process exit
struct WavePool {
    std::mutex mu;
    std::condition_variable cv;
    std::deque<std::shared_ptr<WaveBatch>> resume, start;
    i32 nthreads = 0;
};

WavePool* wave_pool() {
    static WavePool* p = new WavePool();
    return p;
}

void wave_worker(WavePool* p) {
    for (;;) {
        std::shared_ptr<WaveBatch> b;
        {
            std::unique_lock<std::mutex> lk(p->mu);
            p->cv.wait(lk, [p] {
                return !p->resume.empty() || !p->start.empty();
            });
            auto& q = p->resume.empty() ? p->start : p->resume;
            b = q.front();
            if (b->joined.fetch_add(1) + 1 >= b->cap ||
                b->next.load() >= b->n)
                q.pop_front();
        }
        b->run();
    }
}

void wave_submit(const std::shared_ptr<WaveBatch>& b, i32 width,
                 bool resume) {
    WavePool* p = wave_pool();
    std::lock_guard<std::mutex> lk(p->mu);
    while (p->nthreads < width) {
        std::thread(wave_worker, p).detach();
        p->nthreads++;
    }
    b->cap = width;
    (resume ? p->resume : p->start).push_back(b);
    for (i32 i = 0; i < width && i < b->n; i++) p->cv.notify_one();
}

i32 wave_run(i32 n, i32 width, std::function<void(i32)> task) {
    auto b = std::make_shared<WaveBatch>();
    b->n = n;
    b->task = std::move(task);
    if (width > 0 && n > 1) wave_submit(b, width, true);
    b->run();
    b->wait();
    return b->failed.load() ? -1 : 0;
}

}  // namespace

extern "C" {

// the native core's entry points: core_group_start,
// core_group_set_ladder, core_group_advance, core_greedy_consume_fused,
// core_greedy_step, core_ladder_consume, core_support_step,
// core_bridge_step
void wave_bind(void* const* fns) {
    void* const* f = fns;
    core.group_start = (decltype(core.group_start))f[0];
    core.group_set_ladder = (decltype(core.group_set_ladder))f[1];
    core.group_advance = (decltype(core.group_advance))f[2];
    core.greedy_consume_fused = (decltype(core.greedy_consume_fused))f[3];
    core.greedy_step = (decltype(core.greedy_step))f[4];
    core.ladder_consume = (decltype(core.ladder_consume))f[5];
    core.support_step = (decltype(core.support_step))f[6];
    core.bridge_step = (decltype(core.bridge_step))f[7];
}

i64 wave_task_ns() { return task_ns.load(); }

// start batch: a wave's runs made with core_group_start from a batch
// marshal (core_resolve_groups_mt's layout: group g's bundles from the sum
// of grp_nb before it, its cfg rows, ni and nd values each, from that sum
// plus g), ladder pauses set where asked, and each advanced to its first
// pause, all on the pool: run g into hs[g], its pause kind into kinds[g].
// Every array stays alive until wave_join, which every job needs; the
// scanner payloads the runs point into stay alive until core_group_free.
void* wave_start_async(
    i32 n_groups, i32 width, i32 do_bridge, const i32* grp_nb,
    const i32* nh, const i32* const* fixed_p, const i32* const* coords_p,
    const i32* const* mev_p, const i64* mev_cnt,
    const i32* const* iev_p, const i64* iev_cnt,
    const i32* const* frg_p, const i64* frg_cnt,
    const i32* sample_id, const i32* strand, const i64* lpos,
    const i64* rpos, const i64* ins_low, const i64* ins_high,
    const i64* cfg_ints, const double* cfg_dbls, i32 ni, i32 nd,
    i32 device_minv, i32 device_bridge, i32 device_support,
    i32 device_ladder, void** hs, i32* kinds) {
    auto off = std::make_shared<std::vector<size_t>>(n_groups + 1, 0);
    for (i32 g = 0; g < n_groups; g++)
        (*off)[g + 1] = (*off)[g] + (size_t)grp_nb[g];
    auto* job = new std::shared_ptr<WaveBatch>(std::make_shared<WaveBatch>());
    WaveBatch* b = job->get();
    b->n = n_groups;
    b->task = [=](i32 g) {
        size_t o = (*off)[g], c = o + (size_t)g;
        void* run = core.group_start(
            grp_nb[g], do_bridge, nh + o, fixed_p + o, coords_p + o,
            mev_p + o, mev_cnt + o, iev_p + o, iev_cnt + o, frg_p + o,
            frg_cnt + o, sample_id + o, strand + o, lpos + o, rpos + o,
            ins_low + o, ins_high + o, cfg_ints + c * ni, cfg_dbls + c * nd,
            device_minv, device_bridge, device_support);
        if (device_ladder) core.group_set_ladder(run, 1);
        hs[g] = run;
        kinds[g] = core.group_advance(run);
    };
    if (width > 0 && n_groups > 1) wave_submit(*job, width, false);
    return job;
}

i32 wave_join(void* job) {
    auto* j = (std::shared_ptr<WaveBatch>*)job;
    (*j)->run();
    (*j)->wait();
    i32 rc = (*j)->failed.load() ? -1 : 0;
    delete j;
    return rc;
}

// core_greedy_consume_fused on each run: row i of ws / paths at
// i * ws_stride / i * paths_stride elements
i32 wave_consume_fused(i32 n, void* const* hs, const double* ws,
                       i64 ws_stride, const uint8_t* paths, i64 paths_stride,
                       const i32* npaths, i32 maxv, i32 mode, i64* stats2n,
                       i32* kinds, i32 width) {
    return wave_run(n, width, [=](i32 i) {
        kinds[i] = core.greedy_consume_fused(
            hs[i], ws + (size_t)i * ws_stride,
            paths + (size_t)i * paths_stride, npaths[i], maxv, mode,
            stats2n + 2 * (size_t)i);
    });
}

// core_greedy_step on each run (step mode): row i of tables
i32 wave_greedy_step(i32 n, void* const* hs, const float* tables,
                     i64 stride, i32* kinds, i32 width) {
    return wave_run(n, width, [=](i32 i) {
        kinds[i] = core.greedy_step(hs[i], tables + (size_t)i * stride);
    });
}

// core_ladder_consume on each run: row i of arm / tgt
i32 wave_ladder_consume(i32 n, void* const* hs, const i32* arm,
                        i64 arm_stride, const i32* tgt, i64 tgt_stride,
                        const i32* ndec, const i32* status, i32 mode,
                        i64* stats2n, i32* kinds, i32 width) {
    return wave_run(n, width, [=](i32 i) {
        kinds[i] = core.ladder_consume(
            hs[i], arm + (size_t)i * arm_stride,
            tgt + (size_t)i * tgt_stride, ndec[i], status[i], mode,
            stats2n + 2 * (size_t)i);
    });
}

// core_support_step on each run: row i of sums
i32 wave_support_step(i32 n, void* const* hs, const float* sums,
                      i64 stride, i32* kinds, i32 width) {
    return wave_run(n, width, [=](i32 i) {
        kinds[i] = core.support_step(hs[i], sums + (size_t)i * stride);
    });
}

// every queued pier-DP instance of run i fed back in queue order
// (core_bridge_step), instances off[i] .. off[i + 1] - 1 of the pointer
// tables; the pause kind after the last
i32 wave_bridge_feed(i32 n, void* const* hs, const i64* off,
                     const i32* const* ostk, const i32* const* par,
                     const i32* const* pix, i32 V, i32 T, i32 K, i32 S,
                     i32* kinds, i32 width) {
    return wave_run(n, width, [=](i32 i) {
        i32 kind = 0;
        for (i64 j = off[i]; j < off[i + 1]; j++)
            kind = core.bridge_step(hs[i], ostk[j], par[j], pix[j], V, T, K,
                                    S);
        kinds[i] = kind;
    });
}

}  // extern "C"
