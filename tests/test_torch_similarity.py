"""The port's similarity forms (aletsch_tpu_torch/ops/similarity.py: dense
and sparse, plain PyTorch on the CPU device here) against the JAX package's
(XLA on the CPU) and against both host forms, on the same seeded splice
lists.  Tolerance: none.  The [(i, j, count, ratio)] lists must be equal —
same pairs, same float values, same (row-major) order, because the stable
ratio sort downstream tie-breaks on list order (meta/bundle_group.py
_build_splice_similarity).  Then the cohort CLI with --device_similarity
on against the reference with the stage off, byte for byte."""

import os
import random

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import similarity as ref_similarity
from aletsch_tpu_torch.ops import similarity


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def _lists(n, npos, rng, lo=2, hi=14):
    return [sorted(rng.sample(range(npos), rng.randint(lo, hi)))
            for _ in range(n)]


def _host(mod, lists, ms):
    """The host (numpy) form of either package: its device threshold
    raised out of reach."""
    name = "_JAX_THRESHOLD" if mod is ref_similarity else "_DEVICE_THRESHOLD"
    th = getattr(mod, name)
    setattr(mod, name, 10 ** 9)
    try:
        return mod.pairwise_splice_similarity(lists, ms)
    finally:
        setattr(mod, name, th)


def _index(lists):
    sizes = np.array([len(s) for s in lists], dtype=np.int64)
    allp = sorted({p for s in lists for p in s})
    return sizes, {p: i for i, p in enumerate(allp)}, len(allp)


def test_thresholds_equal_reference():
    assert similarity._DEVICE_THRESHOLD == ref_similarity._JAX_THRESHOLD == 48
    assert similarity._K_CAP == ref_similarity._K_CAP == 131072


@pytest.mark.parametrize("n,ms", [(64, 0.2), (64, 0.8), (200, 0.5)])
def test_sparse_matches_host(n, ms):
    lists = _lists(n, 300, random.Random(17))
    host = _host(similarity, lists, ms)
    st0 = dict(similarity.stats)
    dev = similarity.pairwise_splice_similarity(lists, ms)
    assert dev == host
    assert similarity.stats["similarity_sparse"] == st0["similarity_sparse"] + 1
    assert similarity.stats["similarity_dense"] == st0["similarity_dense"]


def test_sparse_overflow_falls_back(monkeypatch):
    """More qualifying candidates than the K cap: the sparse path must
    decline (return None) and the dense path take over, identically."""
    rng = random.Random(23)
    # near-identical lists -> almost every pair qualifies
    base = sorted(rng.sample(range(60), 10))
    lists = [sorted(set(base + [rng.randrange(60)])) for _ in range(80)]
    monkeypatch.setattr(similarity, "_K_CAP", 16)
    host = _host(similarity, lists, 0.2)
    assert len(host) > 16
    sizes, pidx, npos = _index(lists)
    st0 = dict(similarity.stats)
    res = similarity._pairs_device_sparse(lists, sizes, pidx, npos, 0.2)
    assert res is None                      # overflow declined
    dev = similarity.pairwise_splice_similarity(lists, 0.2)
    assert dev == host                      # dense fallback identical
    assert similarity.stats["similarity_overflow"] == \
        st0["similarity_overflow"] + 2
    assert similarity.stats["similarity_dense"] == st0["similarity_dense"] + 1


def test_sparse_empty_and_disjoint():
    lists = [[1, 2], [10, 11], [20, 21]] * 30
    sizes, pidx, npos = _index(lists)
    res = similarity._pairs_device_sparse(lists, sizes, pidx, npos, 0.5)
    assert res == _host(similarity, lists, 0.5)     # identical repeated lists
    disjoint = [[3 * i, 3 * i + 1] for i in range(60)]
    sizes, pidx, npos = _index(disjoint)
    assert similarity._pairs_device_sparse(disjoint, sizes, pidx, npos,
                                           0.5) == []


@pytest.mark.parametrize("n,npos,ms,seed", [
    (48, 60, 0.2, 1), (64, 300, 0.5, 2), (130, 200, 0.9, 3),
    (300, 150, 0.3, 4), (500, 4000, 0.5, 5)])
def test_forms_equal_the_jax_package(n, npos, ms, seed, monkeypatch):
    """Sparse form, dense form and host form of the port == the JAX
    package's device path and host form, on the same seeded lists."""
    lists = _lists(n, npos, random.Random(seed))
    if seed % 2:            # duplicates and subsets: ratios tie and reach 1
        lists[1::3] = [list(s[:max(1, len(s) // 2)]) for s in lists[0::3]][
            :len(lists[1::3])]
    want = ref_similarity.pairwise_splice_similarity(lists, ms)
    assert want == _host(ref_similarity, lists, ms)
    assert similarity.pairwise_splice_similarity(lists, ms) == want   # sparse
    assert _host(similarity, lists, ms) == want
    # the dense form alone: the sparse one made to decline
    monkeypatch.setattr(similarity, "_pairs_device_sparse",
                        lambda *a, **k: None)
    st0 = similarity.stats["similarity_dense"]
    assert similarity.pairwise_splice_similarity(lists, ms) == want
    assert similarity.stats["similarity_dense"] == st0 + 1
    assert n < 100 or len(want) > 0


def test_device_parts_equal_the_jax_functions():
    """The dense product and the sparse form's device part against the
    reference's jitted functions: counts, candidate indices in order, live
    mask and candidate count (the reference pads n to 128-buckets, so its
    flat indices are re-based)."""
    lists = _lists(200, 120, random.Random(9))
    sizes, pidx, npos = _index(lists)
    inc = np.zeros((200, npos), dtype=np.float32)
    for i, s in enumerate(lists):
        for p in s:
            inc[i, pidx[p]] = 1.0
    want_c = ref_similarity._intersection_matrix_device(inc)
    got_c = similarity._intersection_matrix_device(inc)
    assert got_c.dtype == np.float32 and got_c.flags["C_CONTIGUOUS"]
    assert np.array_equal(got_c, want_c) and np.array_equal(got_c, inc @ inc.T)

    rows = torch.tensor([i for i, s in enumerate(lists) for _ in s])
    cols = torch.tensor([pidx[p] for s in lists for p in s])
    n, K = 200, 200 * 200
    idx, cv, live, nq = similarity._sparse_candidates(
        rows, cols, torch.from_numpy(sizes.astype(np.int32)),
        torch.tensor(0.5, dtype=torch.float32), npos, K)
    NB, PB, NZ = (ref_similarity._pad(n), ref_similarity._pad(npos),
                  ref_similarity._pad_nnz(len(rows)))
    fn, _ = ref_similarity._get_sparse_fn(NB, PB, NZ)
    r, c, v = (np.zeros(NZ, np.int32), np.zeros(NZ, np.int32),
               np.zeros(NZ, np.float32))
    r[:len(rows)], c[:len(rows)], v[:len(rows)] = \
        rows.numpy(), cols.numpy(), 1.0
    szs = np.zeros(NB, np.int32)
    szs[:n] = sizes
    ridx, rcv, rlive, rnq = (np.asarray(x) for x in fn(r, c, v, szs,
                                                       np.float32(0.5)))
    k = int(rnq)
    assert int(nq) == k > 0 and int(live.sum()) == int(rlive.sum()) == k
    ri, rj = np.divmod(ridx[:k], NB)
    assert np.array_equal(idx[:k].numpy(), ri * n + rj)
    assert np.array_equal(cv[:k].numpy(), rcv[:k])
    assert np.all(np.diff(idx[:k].numpy()) > 0)     # ascending row-major


def test_tf32_is_off_during_the_product_and_restored():
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        inc = torch.ones((4, 3))
        assert torch.equal(similarity._counts(inc), torch.full((4, 4), 3.0))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.skipif(os.environ.get("ALETSCH_NATIVE_CORE") == "0",
                    reason="compares native vs device clustering")
def test_device_similarity_cohort_parity(tmp_path, monkeypatch):
    """--device_similarity on through the port's CLI == the reference with
    the stage off, every output file byte for byte; once as it is (subsets
    below 48 bundles stay in numpy) and once with every subset of two or
    more bundles sent through the device forms."""
    from aletsch_tpu import __main__ as ref_main
    from aletsch_tpu.sim import simulate_sample
    from aletsch_tpu_torch import __main__ as port_main
    lines = []
    # two samples over the same loci: bundles of both share splices
    for i, seed in enumerate((41, 42)):
        bam = str(tmp_path / ("s%d.bam" % i))
        simulate_sample(bam, seed=seed)
        lines.append("%s %s.bai paired_end\n" % (bam, bam))
    lst = tmp_path / "bams.list"
    lst.write_text("".join(lines))

    def run(main, sub, mode):
        out = tmp_path / sub
        (out / "gtf").mkdir(parents=True)
        assert main(["-i", str(lst), "-o", str(out / "meta.gtf"), "-d",
                     str(out / "gtf"), "--device_similarity", mode,
                     "--device_greedy", "off", "--verbose", "0"]) == 0
        files = {"meta.gtf": (out / "meta.gtf").read_bytes()}
        for f in sorted(os.listdir(out / "gtf")):
            files[f] = (out / "gtf" / f).read_bytes()
        return files

    want = run(ref_main.main, "ref_off", "off")
    assert len(want) > 1
    assert run(port_main.main, "port_off", "off") == want
    assert run(port_main.main, "port_on", "on") == want
    monkeypatch.setattr(similarity, "_DEVICE_THRESHOLD", 2)
    st0 = dict(similarity.stats)
    assert run(port_main.main, "port_on_forced", "on") == want
    assert similarity.stats["similarity_sparse"] > st0["similarity_sparse"]
