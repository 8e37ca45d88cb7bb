"""The port's bridge top-K DP (aletsch_tpu_torch/ops/bridge_topk.py; on the
CPU, bridge_dp runs its plain form) against the JAX package's
(aletsch_tpu/ops/bridge_topk.py, the jitted XLA program on the CPU), both
numpy oracles and the port's own bridge/solver.py DP, on the same
numpy-seeded inputs.  Tolerance zero: every output is int32 and compared
with array_equal, stable tie-breaks included."""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import bridge_topk as ref
from aletsch_tpu_torch.bridge.solver import BridgeSolver
from aletsch_tpu_torch.config import Parameters
from aletsch_tpu_torch.core.graph import SpliceGraph
from aletsch_tpu_torch.ops import bridge_topk as port
from aletsch_tpu_torch.ops.bridge_topk import K, S, SENTINEL

NAMES = ("ostk", "par", "pix")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(batch, device="cpu"):
    out = port.bridge_dp(*port.batch_from_numpy(*batch, device))
    assert all(t.dtype == torch.int32 for t in out)
    return [t.cpu().numpy() for t in out]


def _jax(batch):
    V, E = batch[0].shape[1:]
    return [np.asarray(x) for x in
            ref.get_bridge_fn(V, E, batch[3].shape[1])(*batch)]


def _assert_all_equal(batch):
    got = _port(batch)
    for other in (_jax(batch), port.bridge_dp_host(*batch),
                  ref.bridge_dp_host(*batch)):
        for g, w, name in zip(got, other, NAMES):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert np.array_equal(g, w), name
    return got


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_port_matches_jax_and_oracles(seed, ties):
    rng = np.random.default_rng(100 * ties + seed)
    batch = port.fuzz_batch(rng, 8, 16, 4, 4, ties=ties)
    ostk, par, pix = _assert_all_equal(batch)
    assert (ostk[:, :, 0, 0] >= 0).any() and (par >= 0).any()
    if ties:
        # the batch really is tie-heavy: some vertex keeps two entries
        # with equal stacks, which only the candidate order separates
        tgt = batch[3]
        same = (ostk[:, :, 0] == ostk[:, :, 1]).all(axis=-1) \
            & (ostk[:, :, 0, 0] >= 0) & (tgt >= 0)
        assert same.any()


def test_reference_test_instances():
    """The tie-heavy instances of the JAX package's own kernel test."""
    from test_bridge_topk import _random_instance
    rng = np.random.default_rng(7)
    rows = [_random_instance(rng, 16, 4, 4) for _ in range(8)]
    _assert_all_equal([np.stack([r[i] for r in rows]) for i in range(4)])


def test_production_shape_one_and_many_rows():
    rng = np.random.default_rng(5)
    batch = port.fuzz_batch(rng, 3, ties=True)
    assert batch[0].shape == (3, ref.DEFAULT_V, ref.DEFAULT_E)
    got = _port(batch)
    for g, w in zip(got, _jax(batch)):
        assert np.array_equal(g, w)
    one = _port([a[:1] for a in batch])
    for g, w in zip(one, got):
        assert np.array_equal(g, w[:1])


def test_no_rows():
    batch = [a[:0] for a in port.fuzz_batch(np.random.default_rng(0), 1,
                                            16, 4, 4)]
    ostk, par, pix = _port(batch)
    assert ostk.shape == (0, 4, K, S) and par.shape == pix.shape == (0, 16, K)


def test_lex_order_is_stable_and_covers_int32():
    """_lex_order on keys over the whole int32 range, with many ties, is
    numpy's stable lexsort."""
    rng = np.random.default_rng(3)
    edge = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**30, 2**31 - 1])
    keys = [rng.choice(edge, size=(5, 200)).astype(np.int32)
            for _ in range(6)]
    keys[0][:, :150] = 0            # force ties on the leading keys
    keys[1][:, :100] = -1
    got = port._lex_order([torch.from_numpy(k) for k in keys]).numpy()
    for r in range(5):
        want = np.lexsort([k[r] for k in reversed(keys)])
        assert np.array_equal(got[r], want)


def _backtrace(par, pix, v0, j):
    path = []
    p, q = v0, j
    while True:
        path.append(p)
        np_, nq = int(par[p, q]), int(pix[p, q])
        if np_ < 0:
            break
        p, q = np_, nq
    path.reverse()
    return path


@pytest.mark.parametrize("chunk", range(4))
def test_port_matches_solver_dp(chunk):
    """Entry-for-entry equality (stacks + traced paths, stable ties)
    against the port's bridge/solver.py _dynamic_programming + _trace_back
    on random splice-graph windows with mixed-strand edges, exported as
    native/core_solve.h export_inst exports them."""
    cfg = Parameters()
    assert cfg.bridge_dp_solution_size == K
    assert cfg.bridge_dp_stack_size == S
    V, E, T = 16, 4, 4
    rnd = random.Random(11 + chunk)
    checked = 0
    for trial in range(10):
        n = rnd.randint(4, V)
        gr = SpliceGraph()
        for i in range(n):
            v = gr.add_vertex()
            vi = gr.get_vertex_info(v)
            vi.lpos = 100 * i
            vi.rpos = 100 * i + rnd.randint(1, 60)
        for s in range(n - 1):
            for t in range(s + 1, n):
                if rnd.random() < (0.9 if t == s + 1 else 0.25):
                    if gr.in_degree(t) >= E:
                        continue
                    e = gr.add_edge(s, t)
                    gr.set_edge_weight(e, rnd.choice(
                        [0.5, 1.0, 1.0, 2.0, 3.0, 999999.0]))
                    gr.get_edge_info(e).strand = rnd.choice([0, 0, 1, 2])
        k1 = rnd.randint(0, n - 2)
        k2 = rnd.randint(k1 + 1, n - 1)
        strand = rnd.choice([1, 2])
        solver = SimpleNamespace(gr=gr, cfg=cfg)
        table = BridgeSolver._dynamic_programming(solver, k1, k2, strand)

        P = np.full((V, E), -1, dtype=np.int32)
        Wt = np.zeros((V, E), dtype=np.int32)
        Lv = np.zeros(V, dtype=np.int32)
        for k in range(k1, k2 + 1):
            lr = k - k1
            vi = gr.get_vertex_info(k)
            Lv[lr] = vi.rpos - vi.lpos
            if lr == 0:
                continue
            c = 0
            for e in gr.in_edges(k):
                st = gr.get_edge_info(e).strand
                if st != 0 and st != strand:
                    continue
                if e.s < k1:
                    continue
                P[lr, c] = e.s - k1
                Wt[lr, c] = min(int(gr.get_edge_weight(e)), SENTINEL)
                c += 1
        tgts = sorted(rnd.sample(range(k1 + 1, k2 + 1), min(T, k2 - k1)))
        tgt = np.full(T, -1, dtype=np.int32)
        tgt[:len(tgts)] = [t - k1 for t in tgts]

        ostk, par, pix = (x[0] for x in _port(
            (P[None], Wt[None], Lv[None], tgt[None])))
        for ti, tv in enumerate(tgts):
            want = table[tv]
            paths = BridgeSolver._trace_back(solver, tv, table)
            got_n = int(np.sum(ostk[ti, :, 0] >= 0))
            assert got_n == len(want), (trial, tv)
            for j in range(got_n):
                assert ostk[ti, j].tolist() == list(want[j].stack)
                got_path = [p + k1 for p in
                            _backtrace(par, pix, tv - k1, j)]
                assert got_path == paths[j], (trial, tv, j)
                checked += 1
    assert checked > 10


@pytest.mark.parametrize("nrows", [1, 3, 8])
def test_solver_ships_only_the_live_rows(nrows):
    """DeviceBridge.solve(nrows) with stale rows behind the live ones:
    C-contiguous int32 host arrays of nrows rows, equal to the JAX
    solver's first nrows rows, and the stale rows change nothing."""
    rng = np.random.default_rng(nrows)
    V, E, T, B = 16, 4, 4, 8
    batch = port.fuzz_batch(rng, B, V, E, T, ties=True)
    dev = port.DeviceBridge(batch=B, maxv=V, maxe=E, maxt=T, device="cpu")
    assert dev.device.type == "cpu"
    for i in range(B):
        for dst, src in zip(dev.row(i), batch):
            dst[...] = src[i]
    got = dev.solve(nrows)
    want = [x[:nrows] for x in _jax(batch)]
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == np.int32 and g.flags["C_CONTIGUOUS"], name
        assert g.shape[0] == nrows and np.array_equal(g, w), name
    assert dev.stats["bridge_dispatches"] == 1
    assert dev.stats["bridge_instances"] == nrows
    assert dev.stats["bridge_device_time"] > 0.0


def test_replay_buckets():
    """The ladder solver ships batch sizes that are powers of two; the
    bridge solver replays no CUDA graph and ships its live rows only
    (tests/test_torch_bridge_kernel.py)."""
    from aletsch_tpu_torch.ops import _replay
    assert [_replay.bucket(n, 64) for n in (1, 2, 3, 4, 5, 33, 64)] == \
        [1, 2, 4, 4, 8, 64, 64]
    assert _replay.bucket(50, 48) == 48
    assert not hasattr(_replay, "Replay")
    solver = port.DeviceBridge(batch=2, maxv=4, maxe=2, maxt=2, device="cpu")
    assert not hasattr(solver, "_replays")
    assert "bucket" not in vars(port)


@pytest.mark.cuda
def test_bridge_kernel_matches_oracle_on_card():
    """bridge_dp on the card (one launch of csrc/bridge.cu) and DeviceBridge
    there against the numpy oracle, and one launch a dispatch (needs a GPU
    and nvcc; python3 chip_smoke.py runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    batch = port.fuzz_batch(np.random.default_rng(9), 8, ties=True)
    want = port.bridge_dp_host(*(a[:5] for a in batch))
    n0 = port.bridge_cuda.launches
    for g, w in zip(_port([a[:5] for a in batch], "cuda"), want):
        assert np.array_equal(g, w)
    assert port.bridge_cuda.launches == n0 + 1
    dev = port.DeviceBridge(batch=8, device="cuda")
    for dst, src in zip((dev.P, dev.Wt, dev.Lv, dev.tgt), batch):
        dst[...] = src
    for _ in range(2):
        for g, w in zip(dev.solve(5), want):
            assert np.array_equal(g, w)
    assert dev.stats["bridge_launches"] == 2
