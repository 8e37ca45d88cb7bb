"""inputs.cohort_s (s; layer: inputs): building the cohort and its
warm-up cut from the seed with the frozen generator (cohortgen/), and
reading the BAMs once."""


def read(run):
    return run.setup.get("cohort_s")
