"""CLI entry point of the port: python -m aletsch_tpu_torch -i bam.list -o out.gtf

Counterpart of aletsch_tpu/__main__.py: same flags and outputs.  The
device comes from ALETSCH_TORCH_DEVICE (default cuda).  The multi-process
and multi-host flags (--jobs N>1, --shard, --merge_shards, --jax_dist*) are
parsed as there and refused with exit code 2: parallel/ is not ported yet.
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
    argv, shard, _dump, merge, jobs, jaxdist = _extract_shard_args(argv)
    for flag, given in (("--jax_dist", jaxdist is not None),
                        ("--merge_shards", merge is not None),
                        ("--shard", shard is not None),
                        ("--jobs", jobs is not None and jobs > 1)):
        if given:
            print("%s is not yet ported to aletsch_tpu_torch "
                  "(ROADMAP Queue 1 item 11)" % flag, file=sys.stderr)
            return 2
    params = parse_all(argv)
    cfg = params[DEFAULT]
    if not cfg.profile_only and not cfg.output_gtf_file:
        print_help()
        return 1
    Incubator(params).resolve()
    if cfg.verbose >= 1:
        print("[aletsch_tpu_torch] device: %s" % device_wave.device_stats(),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
