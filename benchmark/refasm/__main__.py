"""Run the reference on a cohort:

    python -m refasm <bams.list> <out dir> [assembler flags ...]

(with benchmark/ on the path) writes <out dir>/meta.gtf and the
per-sample GTFs and feature CSVs under <out dir>/gtf, as the port's CLI
does with -o and -d, and prints one JSON line: the bundles it assembled
and its seconds."""

import json
import os
import sys
import time


def main(argv):
    lst, out, *flags = argv
    os.environ["ALETSCH_DEVICE"] = "0"
    from .config import parse_all
    from .meta.incubator import Incubator
    from .meta.native_core import native_core_available
    if not native_core_available():
        raise RuntimeError("the reference's C++ core did not build")
    os.makedirs(os.path.join(out, "gtf"), exist_ok=True)
    params = parse_all(["-i", lst, "-o", os.path.join(out, "meta.gtf"),
                        "-d", os.path.join(out, "gtf"), *flags])
    t0 = time.perf_counter()
    inc = Incubator(params)
    inc.resolve()
    if inc._pool is not None:
        inc._pool.shutdown(wait=True)
    print(json.dumps({"bundles": inc.stats["bundles"],
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
