"""setup_s (s, end to end, host clock): from the process's start to the
window's: imports, CUDA context, kernel library and C++ core, the
cohort's build from the seed, and the warm-up pass."""


def read(run):
    return run.setup.get("setup_s")
