#!/usr/bin/env python3
"""The benchmark of the port (aletsch_tpu_torch): cohort throughput in
process, one cell a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and the port.  See
bmk/main.py for what a run does and prints, bmk/spec.py for the files a
cell is made of.  Nothing is imported at the top of this file but the
harness's own modules: the cohort builder's worker processes import this
file again.
"""

import sys

if __name__ == "__main__":
    from bmk.main import main
    sys.exit(main(sys.argv[1:]))
