"""bundles_per_s (bundles/s, end to end, host clock): the bundles of all
whole passes of the window over the window's seconds.  A pass reads the
BAMs and writes the outputs, as a user's run does."""


def read(run):
    bundles = sum(p.bundles for p in run.passes if p.error is None)
    if run.window_s <= 0 or bundles <= 0:
        return None
    return bundles / run.window_s
