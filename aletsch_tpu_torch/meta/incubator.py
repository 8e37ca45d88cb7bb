"""Top-level orchestration: samples -> regions -> groups -> transcripts -> GTF.

Re-expresses meta/incubator.{h,cc} as a bulk-synchronous pipeline (the
reference's mutex/try-lock pipelining, incubator.cc:346-494, exists only to
overlap its thread pool; the batched design processes one (chrm, region)
wave at a time and merges functionally):

1. read the BAM list (protocol per line) and build the chrm index
2. profile samples (or load cached profiles); weak samples borrow the
   deepest sample's library/insert-size profile (incubator.cc:116-196)
3. per chromosome region: generate per-sample bundles, cluster them across
   samples per strand, assemble every group, merge transcript sets
4. write the combined GTF plus per-sample GTFs and feature CSVs
   (incubator.cc:673-796)

Counterpart of aletsch_tpu/meta/incubator.py, the same code except where
the port's device side shows: device_wave and the tracer are the port's,
and a device wave's failure propagates instead of falling back to the host
branch.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from ..constants import (DEFAULT, PAIRED_END,
                         TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
from ..io.bam_native import open_bam
from . import device_wave
from .assembler import Assembler
from .bundle_group import BundleGroup
from .generator import Generator
from .previewer import Previewer
from .sample_profile import SampleProfile
from .transcript_store import new_transcript_set
from ..utils.tracing import Tracer

STRANDS = ("+", "-", ".")


def _prep_samples_subprocess(params, samples, nw):
    """Profile samples in parallel worker subprocesses."""
    import pickle
    import subprocess
    import tempfile
    with tempfile.TemporaryDirectory(prefix="aletsch_prof_") as tmp:
        payload_path = os.path.join(tmp, "payload.pkl")
        with open(payload_path, "wb") as fh:
            pickle.dump({"params": params, "samples": samples}, fh)
        outs = [os.path.join(tmp, "out%d.pkl" % i) for i in range(len(samples))]
        pending = list(range(len(samples)))
        running = []
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        while pending or running:
            while pending and len(running) < nw:
                i = pending.pop(0)
                p = subprocess.Popen(
                    [sys.executable, "-m", "aletsch_tpu_torch.parallel.worker",
                     "profile", payload_path, str(i), outs[i]],
                    cwd=repo_root)
                running.append((i, p))
            i, p = running.pop(0)
            rc = p.wait()
            if rc != 0:
                raise RuntimeError("profile worker %d failed (%d)" % (i, rc))
        result = []
        for i in range(len(samples)):
            with open(outs[i], "rb") as fh:
                result.append(pickle.load(fh))
        return result


def _prep_sample(args):
    """Process-pool worker: profile one sample, return the filled profile."""
    sp, params = args
    cfg = params[sp.data_type]
    if cfg.profile_only:
        pre = Previewer(cfg, sp)
        pre.infer_library_type()
        if sp.data_type == PAIRED_END:
            pre.infer_insertsize(capture_regions=True)
        return sp
    if cfg.profile_dir and sp.load_profile(cfg.profile_dir):
        pass
    else:
        pre = Previewer(cfg, sp)
        pre.infer_library_type()
        if sp.data_type == PAIRED_END:
            pre.infer_insertsize(capture_regions=True)
    if not (cfg.profile_dir and
            sp.load_regions(cfg.profile_dir, cfg.min_bundle_gap,
                            cfg.max_read_span)):
        sp.set_batch_boundaries(cfg.min_bundle_gap, cfg.max_read_span)
        if cfg.profile_dir:
            try:
                sp.save_regions(cfg.profile_dir, cfg.min_bundle_gap,
                                cfg.max_read_span)
            except OSError:
                pass
    return sp


_blas_limited = False


def _limit_blas_threads():
    """Pin BLAS pools to one thread: the pipeline issues no large matmuls,
    and OpenBLAS spin-waiting worker threads cost ~9% CPU on a 2-core host
    (measured on the production soak).  Env vars can't do this because the
    interpreter's sitecustomize imports numpy before any of our code runs;
    threadpoolctl applies to already-loaded pools."""
    global _blas_limited
    if _blas_limited:
        return
    try:
        from threadpoolctl import threadpool_limits
        # keep a reference: limits persist for the process lifetime
        _limit_blas_threads._limiter = threadpool_limits(limits=1,
                                                         user_api="blas")
    except Exception:
        pass
    _blas_limited = True


def _region_id(chrm, rid):
    """A region as the spans name it: "chrm:rid"."""
    return "%s:%d" % (chrm, rid)


class ReplayQueue:
    """The region pipeline's queue from the main thread to the replay
    thread (Incubator._run_region_pipeline), bounded by the groups it
    holds.  put() blocks while the queue holds `depth` items or more and,
    together, two merged calls' worth of groups (device_wave.MERGE_GROUPS
    each): one call ready while the last one runs.  An item that is not a
    device wave (a checkpoint load, a host-path region, the closing None)
    weighs a whole call.  get() takes the next item and, where it is a
    device wave, the device waves queued right behind it that merge with
    it (device_wave.merges); it waits for the first item only.  join()
    and task_done() are queue.Queue's, task_done() for several items at
    once."""

    def __init__(self, depth):
        self.depth = max(1, depth)
        self._items = deque()       # (item, groups, flags or None)
        self._groups = 0
        self._unfinished = 0
        self._cond = threading.Condition()

    def put(self, item, groups=device_wave.MERGE_GROUPS, flags=None):
        """Queue item; flags: a device wave's stage flags (Started.flags),
        None for any other item."""
        with self._cond:
            while len(self._items) >= self.depth \
                    and self._groups >= 2 * device_wave.MERGE_GROUPS:
                self._cond.wait()
            self._items.append((item, groups, flags))
            self._groups += groups
            self._unfinished += 1
            self._cond.notify_all()

    def get(self):
        """[the next item, the device waves merged behind it...]."""
        with self._cond:
            while not self._items:
                self._cond.wait()
            item, n, flags = self._items.popleft()
            out = [item]
            while flags is not None and self._items:
                _, m, f = self._items[0]
                if not device_wave.merges(flags, n, f, m):
                    break
                out.append(self._items.popleft()[0])
                n += m
            self._groups -= n
            self._cond.notify_all()
            return out

    def task_done(self, n=1):
        with self._cond:
            self._unfinished -= n
            self._cond.notify_all()

    def join(self):
        """Wait until every item queued has been taken and is done."""
        with self._cond:
            while self._unfinished:
                self._cond.wait()


class Incubator:
    def __init__(self, params, region_filter=None):
        self.params = params
        self.samples = []
        self.sindex = {}           # chrm -> [(sid, tid)]
        self.tts = {}              # (chrm, strand) -> TranscriptSet
        self.verbose = params[DEFAULT].verbose
        self.stats = {"bundles": 0, "groups": 0, "regions": 0}
        self.tracer = Tracer(self.verbose,
                             jax_profile_dir=getattr(
                                 params[DEFAULT], "jax_profile_dir", ""))
        # region_filter(chrm, rid) -> bool: the multi-host shard predicate
        # (regions are the shard unit; every host reads all samples for its
        # regions so combined-graph results are host-count invariant)
        self.region_filter = region_filter
        self._pool = None
        self._native_ts = False
        _limit_blas_threads()

    def _region_pool(self, nw):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=nw)
        return self._pool

    # ---------------------------------------------------------------- driver
    def resolve(self, write_outputs=True, preprofiled=False):
        """incubator.cc:42-81 (phase lines mirror incubator.cc:73-78).

        preprofiled: the caller already ran read_bam_list /
        build_sample_index and installed full profiles on self.samples
        (distributed sample-sharded profiling, parallel/jaxdist.py)."""
        tr = self.tracer
        if not preprofiled:
            with tr.phase("index-inputs"):
                self.read_bam_list()
                self.build_sample_index()
            with tr.phase("profile-samples"):
                self.init_samples()
        if self.params[DEFAULT].profile_only:
            tr.summary()
            return
        # Native transcript sets (native/core_tset.h): replay, fold and
        # output formatting in C++ like the reference (transcript_set.cc,
        # incubator.cc:673-796).  Gated off when the Python sets must be
        # consumed directly: checkpoint pickles (region sets), shard dumps
        # (resolve(write_outputs=False) callers pickle self.tts).  The
        # Python path is the byte-exact oracle (ALETSCH_NATIVE_TSET=0).
        from .native_tset import native_tset_available
        cfg0 = self.params[DEFAULT]
        self._native_ts = (write_outputs
                           and not cfg0.checkpoint_dir
                           and self.region_filter is None
                           and native_tset_available())
        self.init_transcript_sets()
        tr.start_jax_trace()
        with tr.phase("assemble-regions"):
            self._run_region_pipeline(tr)
        tr.stop_jax_trace()
        if write_outputs:
            with tr.phase("write-output"):
                self.postprocess()
        tr.counters["bundles"] = self.stats["bundles"]
        if self.verbose >= 1:
            from .native_core import stats as ncs
            print("[aletsch] native-mt: marshal %.2fs launch %.2fs "
                  "replay %.2fs" % (ncs["mt_marshal_s"], ncs["mt_native_s"],
                                    ncs["mt_replay_s"]), file=sys.stderr)
        tr.summary()

    # ---------------------------------------------------------------- inputs
    def read_bam_list(self):
        """incubator.cc:83-114"""
        from ..constants import DATA_TYPE_NAMES
        from ..io.bam_native import invalidate_cached_readers
        invalidate_cached_readers()     # inputs may differ from a prior run
        cfg = self.params[DEFAULT]
        path = cfg.input_bam_list
        if not os.path.exists(path):
            print("cannot open input-bam-list-file %s" % path)
            sys.exit(0)
        with open(path) as fin:
            for line in fin:
                parts = line.split()
                if len(parts) < 3:
                    continue
                sp = SampleProfile(len(self.samples), cfg.region_partition_length)
                sp.align_file = parts[0]
                sp.index_file = parts[1]
                if parts[2] not in DATA_TYPE_NAMES:
                    print("unknown protocol '%s' in %s (valid: %s)"
                          % (parts[2], path,
                             " ".join(sorted(DATA_TYPE_NAMES))))
                    sys.exit(0)
                sp.data_type = DATA_TYPE_NAMES[parts[2]]
                self.samples.append(sp)

    def build_sample_index(self):
        """incubator.cc:208-259; honors -l/-L chromosome filters."""
        cfg = self.params[DEFAULT]
        ss = set()
        if cfg.chrm_list_file:
            with open(cfg.chrm_list_file) as fin:
                for line in fin:
                    line = line.strip()
                    if line:
                        ss.add(line)
        if cfg.chrm_list_string:
            for c in cfg.chrm_list_string.split(","):
                if c:
                    ss.add(c)
        self.sindex = {}
        for i, sp in enumerate(self.samples):
            if not os.path.exists(sp.align_file):
                # incubator.cc:85-90: unopenable input prints and exits 0
                print("cannot open input bam file %s" % sp.align_file)
                sys.exit(0)
            try:
                r = open_bam(sp.align_file)
            except OSError:
                print("cannot parse bam file %s (not BAM/BGZF?)"
                      % sp.align_file)
                sys.exit(0)
            with r:
                for k, chrm in enumerate(r.header.names):
                    if ss and chrm not in ss:
                        continue
                    self.sindex.setdefault(chrm, []).append((i, k))

    def init_samples(self):
        """incubator.cc:116-196"""
        cfg0 = self.params[DEFAULT]

        def prep(sp):
            cfg = self.params[sp.data_type]
            if cfg.profile_only:
                pre = Previewer(cfg, sp)
                pre.infer_library_type()
                if sp.data_type == PAIRED_END:
                    pre.infer_insertsize(capture_regions=True)
                return
            if cfg.profile_dir and sp.load_profile(cfg.profile_dir):
                pass
            else:
                pre = Previewer(cfg, sp)
                pre.infer_library_type()
                if sp.data_type == PAIRED_END:
                    pre.infer_insertsize(capture_regions=True)
            if not (cfg.profile_dir and
                    sp.load_regions(cfg.profile_dir, cfg.min_bundle_gap,
                                    cfg.max_read_span)):
                sp.set_batch_boundaries(cfg.min_bundle_gap, cfg.max_read_span)
                if cfg.profile_dir:
                    try:
                        sp.save_regions(cfg.profile_dir, cfg.min_bundle_gap,
                                        cfg.max_read_span)
                    except OSError:
                        pass

        nw = min(cfg0.max_threads, len(self.samples), os.cpu_count() or 1)
        total_bytes = sum(os.path.getsize(sp.align_file)
                          for sp in self.samples
                          if os.path.exists(sp.align_file))
        # worker startup only pays off for real inputs; workers are plain
        # subprocesses (see parallel/worker.py for why not multiprocessing).
        # With the native previewer (GIL-releasing C), threads beat the
        # ~1.5s/worker subprocess startup.
        from .native_core import native_core_available
        if nw > 1 and native_core_available():
            with ThreadPoolExecutor(max_workers=nw) as ex:
                list(ex.map(prep, self.samples))
        elif nw > 1 and total_bytes >= 16 * 1024 * 1024:
            try:
                self.samples = _prep_samples_subprocess(self.params,
                                                        self.samples, nw)
            except Exception:
                with ThreadPoolExecutor(max_workers=nw) as ex:
                    list(ex.map(prep, self.samples))
        else:
            for sp in self.samples:
                prep(sp)

        self.borrow_profiles()

    def borrow_profiles(self):
        """Profile borrowing: weakest samples copy the deepest sample's
        stats (incubator.cc:150-196).  Deterministic given the full
        profile set, so distributed profiling (parallel/jaxdist.py) can
        run it identically on every process after the all-gather."""
        cfg0 = self.params[DEFAULT]
        if not cfg0.profile_only and cfg0.profile_dir:
            return
        if not self.samples:
            return
        b = 0
        for i in range(1, len(self.samples)):
            if self.samples[i].spn > self.samples[b].spn:
                b = i
            elif (self.samples[i].spn == self.samples[b].spn and
                  self.samples[i].insert_total > self.samples[b].insert_total):
                b = i
        for sp in self.samples:
            if sp.insert_total < cfg0.min_preview_spliced_reads:
                sp.insertsize_ave = self.samples[b].insertsize_ave
                sp.insertsize_std = self.samples[b].insertsize_std
                sp.insertsize_low = self.samples[b].insertsize_low
                sp.insertsize_high = self.samples[b].insertsize_high
            if sp.spn < cfg0.min_preview_spliced_reads:
                sp.library_type = self.samples[b].library_type
                sp.bam_with_xs = self.samples[b].bam_with_xs
            if cfg0.profile_dir:
                sp.save_profile(cfg0.profile_dir)

    # ------------------------------------------------- region checkpointing
    # TPU-build addition (SURVEY §5: the reference has no failure recovery;
    # per-(chrm, region) checkpointing is natural here because regions are
    # independent and the transcript-set fold is deterministic in region
    # order).  --checkpoint_dir persists each region's transcript delta;
    # a rerun loads completed regions and only assembles the rest.
    def _ckpt_path(self, chrm, rid):
        d = self.params[DEFAULT].checkpoint_dir
        if not d:
            return None
        return os.path.join(d, "region_%s_%d.pkl" % (chrm, rid))

    def _ckpt_load(self, path, chrm, rid, tr):
        """Returns False (and removes the file) when the checkpoint is
        unreadable, so the region is simply re-assembled."""
        import pickle
        try:
            with open(path, "rb") as fh:
                payload = pickle.load(fh)
        except Exception as e:
            print("[aletsch] ignoring corrupt checkpoint %s (%s)"
                  % (path, e), file=sys.stderr)
            try:
                os.remove(path)
            except OSError:
                pass
            return False
        for s in STRANDS:
            ts = payload["sets"].get(s)
            if ts is not None:
                self.tts[(chrm, s)].add(ts, TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
        for k, v in payload["stats"].items():
            self.stats[k] = self.stats.get(k, 0) + v
        tr.region_line(chrm, rid, payload["stats"].get("bundles", 0),
                       payload["stats"].get("groups", 0))
        return True

    def _ckpt_save(self, path, region_sets, dstats):
        import pickle
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as fh:
            pickle.dump({"sets": region_sets, "stats": dstats}, fh)
        os.replace(tmp, path)

    def _run_region_pipeline(self, tr):
        """Assemble all regions, prefetching the next regions' sample scans
        on the thread pool while the current region assembles (the C++
        scanner releases the GIL).  Regions and samples are consumed in
        their canonical order so output is deterministic."""
        cfg = self.params[DEFAULT]
        regions = []
        for chrm in self.sindex:
            for rid in range(self.get_max_region(chrm)):
                if self.region_filter is not None and \
                        not self.region_filter(chrm, rid):
                    continue
                regions.append((chrm, rid))
        threaded = (os.cpu_count() or 1) > 1 and cfg.max_threads > 1 \
            and len(regions) > 0
        if not threaded:
            for chrm, rid in regions:
                ck = self._ckpt_path(chrm, rid)
                if ck and os.path.exists(ck) and \
                        self._ckpt_load(ck, chrm, rid, tr):
                    continue
                b0, g0 = self.stats["bundles"], self.stats["groups"]
                rs = self.process_region(chrm, rid)
                tr.region_line(chrm, rid, self.stats["bundles"] - b0,
                               self.stats["groups"] - g0)
                if ck:
                    self._ckpt_save(ck, rs,
                                    {"bundles": self.stats["bundles"] - b0,
                                     "groups": self.stats["groups"] - g0})
            return
        # Scan pipeline with bounded CROSS-REGION lookahead: the C++
        # scanner releases the GIL and (round 3) the per-wave assembly is
        # one GIL-free native batch call (resolve_groups_native_mt), so
        # prefetching the next regions' scans no longer contends with
        # Python-heavy assembly the way it did in round 2 (49k -> 35k
        # reads/s back then; re-measured a win now).  Results are consumed
        # strictly in canonical (region, sample) order — determinism and
        # outputs unchanged.
        nw = min(cfg.max_threads, 4)
        pool = self._region_pool(nw)
        live = []     # (chrm, rid, ck, has_ckpt) in canonical region order
        for chrm, rid in regions:
            ck = self._ckpt_path(chrm, rid)
            has_ckpt = bool(ck) and os.path.exists(ck)
            live.append((chrm, rid, ck, has_ckpt))
        # Scan tasks are (sample x K-consecutive-regions) BLOCKS: one seek
        # + one native scanner pass replaces K (the per-scan fixed costs
        # — BGZF seek, scanner open, chunk marshal — were ~40% of scan
        # CPU on the production soak).  _generate_sample_block splits the
        # merged bundle stream back per region bit-exactly; quirks mode
        # keeps K=1 (the reference's per-region first-read-drop offsets
        # only exist per region).
        K = 1 if os.environ.get("ALETSCH_REF_QUIRKS") == "1" else \
            int(os.environ.get("ALETSCH_SCAN_BLOCK") or 6)
        runs = []             # (entry, [(ri, rid), ...])
        run_of = {}           # (ri, entry) -> run index
        for b0 in range(0, len(live), K):
            per_sample = {}
            for ri in range(b0, min(b0 + K, len(live))):
                chrm, rid, ck, has_ckpt = live[ri]
                if has_ckpt:
                    continue  # no scans prefetched; loaded in order below
                for e in self._region_entries(chrm, rid):
                    per_sample.setdefault(e, []).append((ri, rid))
            for e, lst in per_sample.items():
                # merged scans require CONSECUTIVE region slots: a rid gap
                # (region filtered out by a shard predicate, checkpointed,
                # or a different chromosome) means the intervening records
                # belong to someone else — break the run there
                seg = []
                for ri, rid in lst:
                    if seg and rid != seg[-1][1] + 1:
                        for rj, _ in seg:
                            run_of[(rj, e)] = len(runs)
                        runs.append((e, seg))
                        seg = []
                    seg.append((ri, rid))
                if seg:
                    for rj, _ in seg:
                        run_of[(rj, e)] = len(runs)
                    runs.append((e, seg))
        import threading
        import time
        futures = {}          # run idx -> Future
        scan_results = {}     # (ri, entry) -> bundles
        state = {"next": 0, "out": 0}
        lock = threading.Lock()

        def _run_task(e, lst):
            rids = [rid for _, rid in lst]
            if len(rids) == 1:
                return {rids[0]: self._generate_sample(e[0], e[1],
                                                       rids[0])}
            return self._generate_sample_block(e[0], e[1], rids)

        def _dec(_f):
            with lock:
                state["out"] -= 1

        def _submit(i):
            e, lst = runs[i]
            with lock:
                state["out"] += 1
            f = pool.submit(_run_task, e, lst)
            f.add_done_callback(_dec)
            futures[i] = f
            return f

        def pump():
            while state["next"] < len(runs):
                with lock:
                    if state["out"] > nw:
                        return
                i = state["next"]
                state["next"] += 1
                if i not in futures:
                    _submit(i)

        def get_result(ri, e):
            key = (ri, e)
            if key in scan_results:
                return scan_results.pop(key)
            i = run_of[key]
            f = futures.get(i)
            if f is None:
                f = _submit(i)    # lookahead exhausted: force-submit
            with tr.span("region.scan_wait"):
                res = f.result()
            ee = runs[i][0]
            for (rj, rjd) in runs[i][1]:
                scan_results[(rj, ee)] = res[rjd]
            return scan_results.pop(key)

        def iter_region(ri):
            chrm, rid, ck, has_ckpt = live[ri]
            for e in self._region_entries(chrm, rid):
                v = get_result(ri, e)
                pump()
                yield e, v
            # keep the pipe full even for regions with no live scans left
            pump()

        pump()
        # Region software pipeline with a dedicated REPLAY WORKER: the
        # main thread only consumes scans + clusters + LAUNCHES each
        # wave's native assembly (meta/native_core.py MtJob); a single
        # ordered worker thread joins the waves and replays their
        # transcripts into the global sets.  Replay is GIL-bound Python,
        # but it overlaps the GIL-free native scan/assembly the main
        # thread drives — the fold order (and therefore every byte) is
        # the submission order, identical to the serial loop.  The queue
        # bounds retained wave memory by groups (ReplayQueue: at least the
        # depth's regions, else two merged calls' groups), and the worker
        # runs the device waves queued together in one call; checkpoint
        # loads ride the same queue so their folds stay in region order.
        depth = int(os.environ.get("ALETSCH_PIPE_DEPTH") or 2)
        replay_q = ReplayQueue(depth)
        replay_err = []

        def _finish_one(item):
            pr, ck, chrm, rid, nb, ng = item
            rs = self._region_finish(pr)
            tr.region_line(chrm, rid, nb, ng)
            if ck:
                with tr.span("replay.fold", _region_id(chrm, rid), tile=True):
                    self._ckpt_save(ck, rs, {"bundles": nb, "groups": ng})

        def _replay_worker(started):
            ri = 0      # the region of `live` whose item comes next
            # replay.idle, wave and replay.fold tile the thread's time, from
            # the moment it was started
            tr.tile_from(started)
            while True:
                with tr.span("replay.idle", _region_id(*live[ri][:2])
                             if ri < len(live) else None, tile=True):
                    items = replay_q.get()
                try:
                    if items[0] is None:
                        return
                    if replay_err:      # drain after a failure
                        for kind, payload in items:
                            job = payload[0][-1] if kind == "region" \
                                else None
                            if isinstance(job, device_wave.Started):
                                job.discard()
                        continue
                    kind, payload = items[0]
                    if kind == "region":
                        # device waves queued together run as one
                        if isinstance(payload[0][-1], device_wave.Started):
                            self._assemble_waves([p[0] for _, p in items])
                        for _, payload in items:
                            _finish_one(payload)
                        ri += len(items)
                    else:               # ordered checkpoint load
                        ck, chrm, rid, done = payload
                        done.append(self._ckpt_load(ck, chrm, rid, tr))
                        ri += bool(done[0])     # else its region follows
                except BaseException as e:   # propagate to the main thread
                    replay_err.append(e)
                finally:
                    replay_q.task_done(len(items))

        worker = threading.Thread(target=_replay_worker,
                                  args=(time.perf_counter(),),
                                  name="aletsch-replay", daemon=True)
        worker.start()

        def _check_err():
            if replay_err:
                replay_q.put(None)
                worker.join()
                raise replay_err[0]

        try:
            for ri, (chrm, rid, ck, has_ckpt) in enumerate(live):
                _check_err()
                if has_ckpt:
                    done = []
                    replay_q.put(("ckpt", (ck, chrm, rid, done)))
                    replay_q.join()     # need the result to decide
                    _check_err()
                    if done and done[0]:
                        continue
                b0, g0 = self.stats["bundles"], self.stats["groups"]
                # a corrupt checkpoint re-assembles from an inline scan
                # (its scans were intentionally not prefetched)
                results = None if has_ckpt else iter_region(ri)
                with tr.span("region.start", _region_id(chrm, rid)):
                    pr = self._region_start(chrm, rid, results)
                nb = self.stats["bundles"] - b0
                ng = self.stats["groups"] - g0
                item = ("region", (pr, ck, chrm, rid, nb, ng))
                job = pr[-1]
                with tr.span("region.backpressure", _region_id(chrm, rid)):
                    if isinstance(job, device_wave.Started):
                        replay_q.put(item, len(job.runs), job.flags)
                    else:
                        replay_q.put(item)
            replay_q.join()
        finally:
            replay_q.put(None)
            worker.join()
        _check_err()

    def _assemble_groups(self, asms, gvs, started=None):
        """Assemble one strand's groups in order.

        Device path: when the wave is large enough, every group's greedy
        max-path DP runs wave-batched on the card (meta/device_wave.py) —
        byte-identical to the serial path (fuzz-enforced), with the batch
        axis over groups; `started` holds the Started records of the
        regions' waves that _region_start launched, one region's or
        several run as one (_assemble_waves).  A device failure
        propagates: there is no fallback to the host branch below.

        Host path is serial on purpose: pipelining native launches on the
        region thread pool was measured SLOWER here (13.6s -> 16-17s on
        the production soak at zero steal, 2-core host) — the per-group
        native call is ~2-3 ms, so future/GIL handoff and
        oversubscription against the scan threads cost more than the
        overlap wins.  launch_group_native / finish_group_native keep the
        split shape for many-core hosts."""
        cfg = self.params[DEFAULT]
        if started is not None \
                or (asms and device_wave.enabled(cfg, len(asms))):
            with self.tracer.span("wave", tile=True):
                device_wave.assemble_groups(asms, gvs, cfg, self.tracer,
                                            started)
            return
        if len(asms) > 1 and (os.cpu_count() or 1) > 1 \
                and cfg.max_threads > 1:
            from .native_core import resolve_groups_native_mt
            nthreads = min(cfg.max_threads, os.cpu_count() or 1)
            if resolve_groups_native_mt(asms, gvs, True, nthreads):
                return
        for asmb, gv in zip(asms, gvs):
            asmb.resolve(gv)

    def init_transcript_sets(self):
        cfg = self.params[DEFAULT]
        if self._native_ts:
            from .native_tset import NativeTSet
            for chrm in self.sindex:
                for s in STRANDS:
                    self.tts[(chrm, s)] = NativeTSet(chrm, -9, cfg)
            return
        for chrm in self.sindex:
            for s in STRANDS:
                self.tts[(chrm, s)] = new_transcript_set(chrm, -9, cfg)

    def get_max_region(self, chrm):
        """incubator.cc:286-298"""
        m = 0
        for sid, tid in self.sindex[chrm]:
            m = max(m, len(self.samples[sid].start1[tid]))
        return m

    # ---------------------------------------------------------- region wave
    def _region_entries(self, chrm, rid):
        entries = []
        for sid, tid in self.sindex[chrm]:
            sp = self.samples[sid]
            if rid >= len(sp.start1[tid]):
                continue
            if sp.start1[tid][rid] >= sp.end1[tid][rid]:
                continue
            entries.append((sid, tid))
        return entries

    def _generate_sample(self, sid, tid, rid):
        sp = self.samples[sid]
        v = []
        Generator(sp, v, self.params[sp.data_type], tid, rid).resolve()
        return v

    def _generate_sample_block(self, sid, tid, rids):
        """One merged native scan spanning the consecutive region slots
        `rids` of one sample: one seek + one scanner pass instead of one
        per region (the region tables are gap-aligned, so records
        partition exactly; sample_profile.cc:167-252 semantics are
        unchanged).  Returns {rid: bundles} with the per-region bundle
        lists — including gene ids — identical to per-region scans."""
        sp = self.samples[sid]
        v = []
        Generator(sp, v, self.params[sp.data_type], tid, rids[0],
                  region_id_last=rids[-1]).resolve()
        out = {r: [] for r in rids}
        ends = [sp.end1[tid][r] for r in rids]
        k = 0
        for bd in v:
            while k < len(rids) - 1 and bd.lpos >= ends[k]:
                k += 1
            out[rids[k]].append(bd)
        # per-region gene ids restart at 0 (generator.cc:203-227 runs one
        # generator per region)
        for r in rids:
            for i, bd in enumerate(out[r]):
                bd.gid = "gene.%d.%d" % (sid, i)
        return out

    def process_region(self, chrm, rid, results=None):
        """Bulk-synchronous version of generate_merge_assemble
        (incubator.cc:346-494 + generate :496-607 + assemble :609-637).

        results, when given, is the prefetched [((sid, tid), bundles)] list
        (resolve() pipelines the scans of upcoming regions on the thread
        pool while this region assembles)."""
        with self.tracer.span("region.start", _region_id(chrm, rid)):
            pending = self._region_start(chrm, rid, results)
        return self._region_finish(pending)

    def _region_start(self, chrm, rid, results=None):
        """Front half of process_region: consume scans, group, cluster,
        and LAUNCH the wave's native assembly (async when eligible).
        Returns the pending-region record for _region_finish; with an
        async launch the native pool assembles this region while the
        caller replays the previous one (GIL-free overlap); a device wave
        is launched on the native wave pool (device_wave.launch).  Its
        callers open the span region.start around it; region.scan_wait
        (blocked on a scan), region.cluster (the strand loop) and
        region.launch (the device wave's launch) lie inside."""
        cfg = self.params[DEFAULT]
        grps = {s: BundleGroup(chrm, s, rid, cfg, self.sindex)
                for s in STRANDS}
        if self._native_ts:
            from .native_tset import NativeTSet
            for s in STRANDS:
                grps[s].tmerge = NativeTSet(chrm, rid, cfg)
            ts_imm = {s: NativeTSet(chrm, rid, cfg) for s in STRANDS}
        else:
            ts_imm = {s: new_transcript_set(chrm, rid, cfg)
                      for s in STRANDS}
        imm_counts = {s: 0 for s in STRANDS}
        if results is None:
            results = [(e, self._generate_sample(e[0], e[1], rid))
                       for e in self._region_entries(chrm, rid)]
        for (sid, tid), v in results:
            self.stats["bundles"] += len(v)
            index = 0           # per sample, like incubator.cc:552
            for bd in v:
                if len(bd.splices) >= 1:
                    grps[bd.strand].gset.append(bd)
                    # reference accounting quirk (incubator.cc:523-601):
                    # spliced bundles are std::move'd into the gsets and
                    # their moved-from husks still flow through the
                    # immediate-assembly loop -- consuming an index and
                    # incrementing the strand's num_assembled, which
                    # shifts every group's `instance` id (bundle.cc:40,
                    # incubator.cc:611).  Replicated so transcript ids
                    # match the reference binary byte-for-byte.
                    index += 1
                    imm_counts[bd.strand] += 1
                else:
                    # splice-free bundles are assembled immediately
                    # (native core when the bundle is a pristine scan)
                    from .native_core import resolve_group_native
                    asmb = Assembler(cfg, ts_imm[bd.strand], rid,
                                     sid, index)
                    index += 1
                    if not resolve_group_native(asmb, [bd],
                                                do_bridge=False):
                        asmb.assemble_single(bd)
                    imm_counts[bd.strand] += 1
        # cluster every strand first, then assemble ALL strands' groups in
        # one wave: on the host path the native batch call runs them on a
        # C++ thread pool (resolve_groups_native_mt), on the device path
        # the wave batch spans more groups per dispatch.  Replay order is
        # (strand, group) — identical bytes to the per-strand loop.
        all_asms = []
        all_gvs = []
        with self.tracer.span("region.cluster"):
            for s in STRANDS:
                g = grps[s]
                if imm_counts[s] >= 1:
                    g.num_assembled += imm_counts[s]
                    g.tmerge.add(ts_imm[s],
                                 TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
                g.resolve()
                self.tracer.group_line(chrm, s, rid, len(g.gset),
                                       len(g.gvv))
                instance = g.num_assembled + 1
                gi = STRANDS.index(s)
                for gv_idx in g.gvv:
                    gv = [g.gset[j] for j in gv_idx]
                    if len(gv) == 0:
                        continue
                    all_gvs.append(gv)
                    all_asms.append(Assembler(cfg, g.tmerge, rid, gi,
                                              instance))
                    instance += 1
                    self.stats["groups"] += 1
        job = None
        own = all_asms and "_assemble_groups" not in self.__dict__
        if own and device_wave.enabled(cfg, len(all_asms)):
            # the device wave's runs made and started on the native wave
            # pool while the replay thread works on the regions before this
            if device_wave.pool_width(cfg) > 0:
                with self.tracer.span("region.launch"):
                    job = device_wave.launch(all_asms, all_gvs, cfg)
                device_wave.add_stats(prestarted_groups=len(all_asms))
        elif own and len(all_asms) > 1 and (os.cpu_count() or 1) > 1 \
                and cfg.max_threads > 1:
            from .native_core import launch_groups_native_mt
            # leave one core for the Python thread the pool overlaps with
            # (replay/merge of the previous wave + the next wave's scans);
            # a full-width pool oversubscribes and was measured slower
            nthreads = int(os.environ.get("ALETSCH_MT_THREADS") or
                           max(1, min(cfg.max_threads, os.cpu_count() or 1) - 1))
            job = launch_groups_native_mt(all_asms, all_gvs, True, nthreads)
        return (chrm, rid, grps, all_asms, all_gvs, job)

    def _assemble_waves(self, pendings):
        """The device waves of one region or more, consecutive and
        started on the wave pool with the same stage flags, as one wave
        (the replay thread's call, ReplayQueue.get): their groups joined in
        region order, their Started records together.  The span wave is
        one range for the call, in the first region's name; each region's
        fold follows (_region_finish)."""
        chrm, rid = pendings[0][:2]
        with self.tracer.region(_region_id(chrm, rid)):
            self._assemble_groups([a for p in pendings for a in p[3]],
                                  [gv for p in pendings for gv in p[4]],
                                  [p[5] for p in pendings])

    def _region_finish(self, pending):
        """Back half of process_region: join (or run) the wave's group
        assembly, then fold the region transcript sets into the global
        per-(chrm, strand) sets.  A device wave started on the wave pool
        is assembled before this, by the replay thread (_assemble_waves).
        Replay is in (strand, group) order — bytes identical to the
        unsplit process_region.  Spans: wave (_assemble_groups), then
        replay.fold."""
        chrm, rid, grps, all_asms, all_gvs, job = pending
        tr = self.tracer
        with tr.region(_region_id(chrm, rid)):
            if job is None:
                self._assemble_groups(all_asms, all_gvs)
            elif not isinstance(job, device_wave.Started):
                job.join()
            region_sets = {}
            with tr.span("replay.fold", tile=True):
                for s in STRANDS:
                    g = grps[s]
                    # fold region transcripts into the global
                    # per-(chrm,strand) set
                    self.tts[(chrm, s)].add(g.tmerge,
                                            TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
                    region_sets[s] = g.tmerge
                    g.gset = []
                    g.clear()
                # the region's assemblers and bundles are released here,
                # inside the span, not where its last reference drops
                all_asms.clear()
                all_gvs.clear()
        return region_sets

    # ---------------------------------------------------------------- output
    def postprocess(self):
        """incubator.cc:673-711"""
        cfg = self.params[DEFAULT]
        # synthetic "combined" sample
        sn = SampleProfile(len(self.samples),
                           self.samples[0].region_partition_length
                           if self.samples else cfg.region_partition_length)
        self.samples.append(sn)
        if self._native_ts:
            # fully-native output phase: sync + combined GTF + per-sample
            # GTF/CSV formatting in C++, samples partitioned across
            # threads (incubator.cc:673-796)
            from . import native_tset
            from ..io.gtf import gtf_source
            for tm in self.tts.values():
                tm.sync()
            ordered = [(chrm, tm)
                       for (chrm, _s), tm in sorted(self.tts.items())]
            native_tset.write_combined(ordered, cfg.output_gtf_file,
                                       gtf_source())
            if cfg.output_gtf_dir:
                os.makedirs(cfg.output_gtf_dir, exist_ok=True)
                nthreads = max(1, min(cfg.max_threads, os.cpu_count() or 1))
                native_tset.write_individual(
                    ordered, cfg.output_gtf_dir, len(self.samples),
                    cfg.min_single_exon_individual_coverage, gtf_source(),
                    nthreads)
            return
        # deferred per-sample-copy propagation (transcript_set.cc:68-76;
        # see TranscriptSet.sync_samples) — must precede every writer
        for tm in self.tts.values():
            tm.sync_samples()
        # truncate like the reference's ofstream (incubator.cc:676): a rerun
        # with the same -o must replace the output, not append to it
        with open(cfg.output_gtf_file, "w") as fout:
            self.write_combined_gtf(fout)
        if cfg.output_gtf_dir:
            # the reference's ofstream silently writes nothing when the
            # directory is missing (incubator.cc:745+); create it instead
            os.makedirs(cfg.output_gtf_dir, exist_ok=True)
            self.write_individual_gtfs()

    def write_combined_gtf(self, fout):
        """incubator.cc:713-743"""
        for (chrm, strand), tm in sorted(self.tts.items()):
            for h in sorted(tm.mt.keys()):
                for item in tm.mt[h]:
                    t = item.trst
                    assert len(item.samples) == t.count2
                    t.write(fout, -1, len(item.samples))

    def write_individual_gtfs(self):
        """incubator.cc:745-796 for all samples in ONE pass over the
        transcript sets (the reference re-scans everything per sample file;
        per-file output order is identical because items are visited in the
        same global order either way)."""
        cfg = self.params[DEFAULT]
        n = len(self.samples)
        fgs, ffs = [], []
        try:
            for sid in range(n):
                fgs.append(open(os.path.join(cfg.output_gtf_dir,
                                             "%d.gtf" % sid), "w"))
                ffs.append(open(os.path.join(cfg.output_gtf_dir,
                                             "%d.trstFeature.csv" % sid),
                                "w"))
            min_se = cfg.min_single_exon_individual_coverage
            for (chrm, strand), tm in sorted(self.tts.items()):
                for h in sorted(tm.mt.keys()):
                    for item in tm.mt[h]:
                        for j, t in item.samples.items():
                            if j == -1:
                                j = n - 1
                            if len(t.exons) == 1:
                                if t.cov2 < min_se:
                                    continue
                                t.write(fgs[j], t.cov2, t.count2)
                            else:
                                t.write(fgs[j], t.cov2, t.count2)
                                t.write_features(ffs[j])
        finally:
            for fh in fgs + ffs:
                fh.close()

    def write_individual_gtf(self, sid):
        """Single-sample variant of write_individual_gtfs (kept for direct
        use; incubator.cc:745-796).  Python-set path only: run with
        ALETSCH_NATIVE_TSET=0 to use it."""
        assert not self._native_ts, \
            "write_individual_gtf needs the Python transcript sets"
        cfg = self.params[DEFAULT]
        gtf_path = os.path.join(cfg.output_gtf_dir, "%d.gtf" % sid)
        ftr_path = os.path.join(cfg.output_gtf_dir, "%d.trstFeature.csv" % sid)
        for tm in self.tts.values():
            tm.sync_samples()
        with open(gtf_path, "w") as fg, open(ftr_path, "w") as ff:
            for (chrm, strand), tm in sorted(self.tts.items()):
                for h in sorted(tm.mt.keys()):
                    for item in tm.mt[h]:
                        for j, t in item.samples.items():
                            if j == -1:
                                j = len(self.samples) - 1
                            if j != sid:
                                continue
                            if (len(t.exons) == 1 and
                                    t.cov2 < cfg.min_single_exon_individual_coverage):
                                continue
                            t.write(fg, t.cov2, t.count2)
                            if len(t.exons) > 1:
                                t.write_features(ff)
