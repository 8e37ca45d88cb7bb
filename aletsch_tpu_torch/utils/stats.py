"""Small statistics helpers (rnacore/binomial.{h,cc})."""

from __future__ import annotations


def compute_binomial_pvalue(n, pr, x):
    """P[X >= x] for X ~ Binomial(n, pr) (binomial.h:8-13).

    Matches boost::math::binomial cdf complement semantics.
    """
    from scipy.stats import binom
    if x <= 0:
        return 1.0
    if x > n:
        return 0.0
    # survival function at x-1 = P[X >= x]
    return float(binom.sf(x - 1, n, pr))
