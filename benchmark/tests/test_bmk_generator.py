"""The frozen generator (cohortgen/) writes the port's cohort builder's
bytes at a small cut and at each builder's default seed, and another
seed changes them."""

import hashlib
import os

import pytest

from aletsch_tpu_torch import cohorts as port_cohorts
from cohortgen import cohorts as frozen

# builder, its small cut, its default seed
CUTS = [("paired_end", dict(n_genes=5, n_samples=2),
         port_cohorts.PAIRED_END_SEED),
        ("smartseq", dict(n_genes=6, n_cells=3, chrlen=2_000_000),
         port_cohorts.SMARTSEQ_SEED),
        ("long_read", dict(n_genes=4, n_samples=2),
         port_cohorts.LONG_READ_SEED)]


def digest(lst):
    """{file name: sha256} of a cohort's BAMs and bams.list (paths made
    relative)."""
    base = os.path.dirname(lst)
    out = {}
    for name in sorted(os.listdir(base)):
        with open(os.path.join(base, name), "rb") as fh:
            data = fh.read()
        out[name] = hashlib.sha256(data.replace(
            base.encode(), b"<dir>")).hexdigest()
    return out


@pytest.mark.parametrize("builder,cut,seed", CUTS,
                         ids=[c[0] for c in CUTS])
def test_frozen_generator_writes_the_ports_bytes(tmp_path, builder, cut,
                                                 seed):
    lst_p, n_p = port_cohorts.BUILDERS[builder](str(tmp_path / "p"),
                                               seed=seed, **cut)
    lst_f, n_f = frozen.BUILDERS[builder](str(tmp_path / "f"), seed=seed,
                                          **cut)
    assert n_p == n_f > 0
    assert digest(lst_p) == digest(lst_f)


@pytest.mark.parametrize("builder,cut,seed", CUTS,
                         ids=[c[0] for c in CUTS])
def test_another_seed_changes_the_bytes(tmp_path, builder, cut, seed):
    a, _ = frozen.BUILDERS[builder](str(tmp_path / "a"), seed=seed, **cut)
    b, _ = frozen.BUILDERS[builder](str(tmp_path / "b"), seed=seed + 1,
                                    **cut)
    da, db = digest(a), digest(b)
    assert da["bams.list"] == db["bams.list"]
    assert all(da[k] != db[k] for k in da if k.endswith(".bam"))


def test_a_seed_past_32_bits_builds_the_same_bytes_twice(tmp_path):
    seed = 2 ** 31 + 123456789
    cut = dict(n_genes=3, n_samples=2)
    a, _ = frozen.BUILDERS["paired_end"](str(tmp_path / "a"), seed=seed,
                                         **cut)
    b, _ = frozen.BUILDERS["paired_end"](str(tmp_path / "b"), seed=seed,
                                         jobs=2, **cut)
    assert digest(a) == digest(b)
