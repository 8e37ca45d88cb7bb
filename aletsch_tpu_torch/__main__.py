"""CLI entry point of the port: python -m aletsch_tpu_torch -i bam.list -o out.gtf

Counterpart of aletsch_tpu/__main__.py: same flags and outputs.  The
device comes from ALETSCH_TORCH_DEVICE (default cuda).  Region sharding
and single-host multi-process execution run as there (parallel/):
  --shard <h> <H> --shard_dump <path>   assemble shard h of H, dump sets
  --merge_shards <p1,p2,...>            merge shard dumps, write outputs
  --jobs <N>                            single-host N-process execution
  --jax_dist <pid> <P> <host:port>      a torch.distributed (gloo) process
                                        group: this process assembles
                                        shard pid of P and the shard
                                        payloads ride collectives
                                        (parallel/jaxdist.py); process 0
                                        writes the merged outputs
  --jax_dist_launch <N>                 spawn the N-process group locally
                                        on a free port and wait
"""

import sys

from .config import parse_all, print_help
from .constants import DEFAULT
from .meta import device_wave
from .meta.incubator import Incubator


def _extract_shard_args(argv):
    shard = None
    dump = None
    merge = None
    jobs = None
    jaxdist = None
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--jax_dist":
            jaxdist = (int(argv[i + 1]), int(argv[i + 2]), argv[i + 3])
            i += 4
        elif a == "--jax_dist_launch":
            jaxdist = ("launch", int(argv[i + 1]))
            i += 2
        elif a == "--shard":
            shard = (int(argv[i + 1]), int(argv[i + 2]))
            i += 3
        elif a == "--shard_dump":
            dump = argv[i + 1]
            i += 2
        elif a == "--merge_shards":
            merge = argv[i + 1].split(",")
            i += 2
        elif a == "--jobs":
            jobs = int(argv[i + 1])
            i += 2
        else:
            out.append(a)
            i += 1
    return out, shard, dump, merge, jobs, jaxdist


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0:
        print_help()
        return 0
    argv, shard, dump, merge, jobs, jaxdist = _extract_shard_args(argv)
    params = parse_all(argv)
    cfg = params[DEFAULT]
    if jaxdist is not None:
        if jaxdist[0] == "launch":
            from .parallel.jaxdist import launch_jax_distributed
            launch_jax_distributed(argv, jaxdist[1])
        else:
            from .parallel.jaxdist import run_jax_distributed
            run_jax_distributed(params, jaxdist[0], jaxdist[1], jaxdist[2])
        return 0
    if merge is not None:
        from .parallel.distributed import merge_shards
        merge_shards(params, merge)
        return 0
    if shard is not None:
        from .parallel.distributed import run_region_shard
        if not dump:
            print("--shard requires --shard_dump <path>")
            return 1
        run_region_shard(params, shard[0], shard[1], dump)
        return 0
    if not cfg.profile_only and not cfg.output_gtf_file:
        print_help()
        return 1
    if jobs is not None and jobs > 1 and not cfg.profile_only:
        from .parallel.jobs import run_parallel
        run_parallel(params, jobs)
        return 0
    Incubator(params).resolve()
    if cfg.verbose >= 1:
        print("[aletsch_tpu_torch] device: %s" % device_wave.device_stats(),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
