"""Multi-host scale-out: region-sharded assembly with deterministic merge.

The reference is single-process; its cross-sample state is shared memory
(SURVEY §2.8).  The scale-out unit here is the (chrm, region) grid cell:
every host processes a disjoint subset of regions over *all* samples, so
combined-graph assembly sees exactly the same per-locus inputs as a
single-host run and the merged output is bitwise identical regardless of
host count (test_distributed.py proves 1-host == N-shard).

Workflow:
    # on each host h of H
    run_region_shard(params, h, H, dump_path_h)
    # on host 0 (or anywhere with all dumps)
    merge_shards(params, [dump_path_0, ...])

Dumps are pickled per-(chrm,strand) TranscriptSets — the analogue of the
all-gather of per-locus summaries over DCN; with jax.distributed the same
payloads ride process-group collectives instead of files.
"""

from __future__ import annotations

import pickle

from ..constants import TRANSCRIPT_COUNT_ADD_COVERAGE_ADD
from ..meta.incubator import Incubator


def region_shard_filter(host_id, n_hosts):
    """Deterministic round-robin over the flattened region grid."""
    def f(chrm, rid):
        # stable hash: regions interleave across hosts within a chromosome
        return (hash_chrm(chrm) + rid) % n_hosts == host_id
    return f


def hash_chrm(chrm):
    h = 0
    for c in chrm:
        h = (h * 131 + ord(c)) & 0x7FFFFFFF
    return h


def run_region_shard(params, host_id, n_hosts, dump_path):
    """Assemble this host's region shard; dump its transcript sets."""
    inc = Incubator(params, region_filter=region_shard_filter(host_id, n_hosts))
    inc.resolve(write_outputs=False)
    payload = {
        "tts": inc.tts,
        "n_samples": len(inc.samples),
        "stats": inc.stats,
    }
    with open(dump_path, "wb") as fh:
        pickle.dump(payload, fh)
    return inc


def merge_payloads(params, payloads):
    """Merge per-host shard payloads and write the final outputs.

    The merge is the same commutative TranscriptSet union the single-host
    postprocess performs (transcript_set.cc merge-join), keyed and ordered
    deterministically.  `payloads` is a list of dicts as produced by
    run_region_shard — regardless of whether they arrived via dump files
    or a jax.distributed all-gather (parallel/jaxdist.py).
    """
    inc = Incubator(params)
    inc.read_bam_list()
    inc.build_sample_index()
    inc.init_transcript_sets()
    n_samples = None
    for payload in payloads:
        n_samples = payload["n_samples"]
        for key, ts in sorted(payload["tts"].items()):
            if key not in inc.tts:
                inc.tts[key] = ts
            else:
                inc.tts[key].add(ts, TRANSCRIPT_COUNT_ADD_COVERAGE_ADD)
        for k, v in payload["stats"].items():
            inc.stats[k] = inc.stats.get(k, 0) + v
    # postprocess() appends the synthetic combined sample itself
    while n_samples is not None and len(inc.samples) > n_samples:
        inc.samples.pop()
    inc.postprocess()
    return inc


def merge_shards(params, dump_paths):
    """File-dump flavor of the merge (each path = one host's pickle)."""
    payloads = []
    for path in dump_paths:
        with open(path, "rb") as fh:
            payloads.append(pickle.load(fh))
    return merge_payloads(params, payloads)
