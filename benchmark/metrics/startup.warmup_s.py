"""startup.warmup_s (s; layer: start-up): the warm-up pass's wall, on the
cohort's first genes with the cell's flags (the solvers' buffers, plans
and lazy loads)."""


def read(run):
    return run.setup.get("warmup_s")
