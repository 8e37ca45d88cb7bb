"""Port's fused drain (aletsch_tpu_torch/ops) vs the JAX package's drains.

On the CPU the port runs the plain PyTorch version (drain_torch); it must
equal, bit for bit, the XLA f64 drain (greedy_fused.get_fused_fn), the
numpy oracle drain_host and, in f32, the Pallas kernel in interpret mode.
The drain is pure sub/min/max/compare, so every tolerance is zero.  The
CUDA kernel takes the candidates in another order than these (each
destination keeps a running best, sources in increasing order); that order
is emulated here in numpy and held to the same references.  The CUDA
kernel's own check is marked `cuda` and runs only on a card."""

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import crossover, greedy_fused, pallas_drain
from aletsch_tpu_torch import device as port_device
from aletsch_tpu_torch.ops import drain as tdrain
from aletsch_tpu_torch.ops import greedy_fused as tfused

CPU = torch.device("cpu")


def _xla(W, P, sink, scal, maxp):
    import jax
    B, V, _ = W.shape
    fn = greedy_fused.get_fused_fn(B, V, maxp)
    with jax.enable_x64():
        import jax.numpy as jnp
        out = fn(jnp.asarray(W), jnp.asarray(P), jnp.asarray(sink),
                 *[jnp.asarray(np.ascontiguousarray(scal[:, i]))
                   for i in range(3)])
    return tuple(np.asarray(o) for o in out)


def _host(W, P, sink, scal, maxp):
    return greedy_fused.drain_host(W, P, sink, scal[:, 0], scal[:, 1], scal[:, 2],
                          maxp=maxp)


def _torch(W, P, sink, scal, maxp, dtype=torch.float64):
    Wt, Pt, st, sc = tfused.batch_from_numpy(W, P, sink, scal, CPU)
    out = tdrain.drain(Wt.to(dtype), Pt, st, sc.to(dtype), maxp)
    return tuple(o.numpy() for o in out)


def _assert_same(a, b):
    pa, wa, na = a
    pb, wb, nb = b
    assert np.array_equal(na, nb)
    assert np.array_equal(pa.astype(bool), pb.astype(bool))
    assert wa.dtype == wb.dtype
    iv = np.int64 if wa.dtype == np.float64 else np.int32
    assert np.array_equal(wa.view(iv), wb.view(iv))


@pytest.mark.parametrize("seed", [42, 7])
def test_drain_torch_f64_fuzz_matches_xla_and_host(seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        batch = tdrain.fuzz_batch(rng, 16, 24)
        t = _torch(*batch, greedy_fused.DEFAULT_P)
        _assert_same(t, _host(*batch, greedy_fused.DEFAULT_P))
        _assert_same(t, _xla(*batch, greedy_fused.DEFAULT_P))
        assert t[2].sum() > 0


def test_fuzz_batch_full_width_matches_xla_and_host():
    """The full-width batches the on-card check draws: every graph spans
    all V vertices."""
    batch = tdrain.fuzz_batch(np.random.default_rng(9), 8, 32, n_vertices=32)
    assert (batch[2] == 31).all()
    assert (batch[0][:, :, 31] >= 0).any(axis=1).all()
    t = _torch(*batch, greedy_fused.DEFAULT_P)
    _assert_same(t, _host(*batch, greedy_fused.DEFAULT_P))
    _assert_same(t, _xla(*batch, greedy_fused.DEFAULT_P))
    assert (t[2] > 0).any()


@pytest.mark.parametrize("seed", [3, 11, 29, 57])
def test_drain_torch_f64_synth_matches_xla_and_host(seed):
    batch = crossover.synth_batch(16, 64, seed=seed)
    t = _torch(*batch, 64)
    _assert_same(t, _host(*batch, 64))
    _assert_same(t, _xla(*batch, 64))


def test_inactive_rows_and_maxp_cap():
    W, P, sink, scal = crossover.synth_batch(8, 64, seed=3)
    sink = sink.copy()
    sink[::2] = 0
    for maxp in (64, 2):
        t = _torch(W, P, sink, scal, maxp)
        _assert_same(t, _host(W, P, sink, scal, maxp))
        _assert_same(t, _xla(W, P, sink, scal, maxp))
        assert (t[2][::2] == 0).all() and (t[2][1::2] > 0).all()
        assert (t[2] <= maxp).all()
        assert not t[0][::2].any() and not t[1][::2].any()


def test_drained_and_empty_graphs():
    """A path below min coverage yields nothing; a diamond drains in two
    rounds; a graph whose sink is unreachable yields nothing."""
    B, V = 4, 8
    W = np.full((B, V, V), greedy_fused.NEG)
    P = np.full((B, V, V), -1, dtype=np.int32)
    sink = np.zeros(B, dtype=np.int32)
    W[1, 0, 1], P[1, 0, 1] = 1.5, 0
    W[1, 1, 2], P[1, 1, 2] = 1.5, 0
    sink[1] = 2
    for (u, v, w, p) in ((0, 1, 10.0, 0), (1, 3, 10.0, 0), (0, 2, 5.0, 0),
                         (2, 3, 5.0, 1)):
        W[2, u, v], P[2, u, v] = w, p
    sink[2] = 3
    W[3, 0, 1], P[3, 0, 1] = 9.0, 0
    sink[3] = 5
    scal = np.tile([2.0, 0.01, 1e-8], (B, 1))
    t = _torch(W, P, sink, scal, 8)
    assert t[2].tolist() == [0, 0, 2, 0]
    assert t[1][2, 0] == 10.0 and t[1][2, 1] == 5.0
    _assert_same(t, _host(W, P, sink, scal, 8))
    _assert_same(t, _xla(W, P, sink, scal, 8))


def test_zero_rows():
    W, P, sink, scal = crossover.synth_batch(1, 16, seed=3, n_vertices=12)
    paths, ws, npaths = _torch(W[:0], P[:0], sink[:0], scal[:0], 4)
    assert paths.shape == (0, 4, 16) and ws.shape == (0, 4)
    assert npaths.shape == (0,)
    fd = tfused.DeviceGreedyFused(batch=4, maxv=16, maxp=4, device=CPU)
    paths, ws, npaths = fd.solve(0)
    assert paths.shape == (0, 4, 16) and npaths.shape == (0,)
    assert fd.stats["fused_dispatches"] == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_drain_torch_f32_matches_pallas_interpret(seed):
    W, P, sink, scal = crossover.synth_batch(16, 64, seed=seed)
    pp, wsp, npp = pallas_drain.drain_pallas(
        W, P, sink, scal[:, 0], scal[:, 1], scal[:, 2], maxp=64,
        interpret=True)
    t = _torch(W, P, sink, scal, 64, dtype=torch.float32)
    _assert_same(t, (pp, wsp, npp))


def _push_drain(W, P, sink, scal, maxp):
    """The drain in the order the Hopper kernel takes it (csrc/drain.cu,
    "push" form), in numpy: each destination v keeps its best candidate so
    far and its key P << 6 | u; step u = 0 .. sink-1 offers
    min(T[u], W[u, v]) to every v in (u, sink], where T[u] is final; a
    candidate replaces the best if it is larger, or equal with a larger
    key.  The parent falls out of the sweep, and the walk back subtracts
    the bottleneck as drain_host does."""
    B, V, _ = W.shape
    neg, pos = W.dtype.type(greedy_fused.NEG), W.dtype.type(greedy_fused.POS)
    paths = np.zeros((B, maxp, V), dtype=np.uint8)
    ws = np.zeros((B, maxp), dtype=W.dtype)
    npaths = np.zeros(B, dtype=np.int32)
    idx = np.arange(V)
    for b in range(B):
        s = int(sink[b])
        if s <= 0 or s >= V:
            continue
        Wb = W[b].copy()
        mincov, guard, smin = scal[b]
        for k in range(maxp):
            best = np.full(V, neg)
            best[0] = pos
            key = np.full(V, -1, dtype=np.int64)
            for u in range(s):
                tu = best[u]
                c = np.minimum(Wb[u], tu)
                ku = (P[b, u].astype(np.int64) << 6) | u
                # as the kernel tests it: min(w, tu) > best <=> w > best
                # and tu > best, and >= likewise
                gt = (Wb[u] > best) & (tu > best)
                ge = (Wb[u] >= best) & (tu >= best)
                take = ((idx > u) & (idx <= s) & (Wb[u] >= 0) & (tu >= 0)
                        & (gt | (ge & (ku > key))))
                best = np.where(take, c, best)
                key = np.where(take, ku, key)
            w = best[s]
            if not (w >= 0 and w > mincov):
                break
            x = s
            paths[b, k, 0] = 1
            while x > 0:
                paths[b, k, x] = 1
                u = int(key[x] & 63)
                d = Wb[u, x] - w
                Wb[u, x] = neg if abs(d) <= smin else \
                    (guard if d <= guard else d)
                x = u
            ws[b, k] = w
            npaths[b] = k + 1
    return paths, ws, npaths


@pytest.mark.parametrize("V", [16, 33, 64])
@pytest.mark.parametrize("gen", ["ties", "batch"])
def test_push_order_matches_plain_host_and_xla(gen, V):
    """The kernel's sweep order and tie handling, emulated on the CPU,
    against drain_torch, drain_host and the XLA drain, bit for bit, on
    batches full of equal candidates with different P, 0.0 and -0.0 edges,
    sinks on both sides of 32, sinks before the last vertex, rows with no
    path and inactive rows."""
    rng = np.random.default_rng(100 + V)
    if gen == "ties":
        batch = tdrain.fuzz_ties(rng, 32, V)
        W, P, sink, _ = batch
        assert (sink == 0).any() and (sink > 0).any()
        if V == 64:
            assert ((sink > 0) & (sink < 32)).any() and (sink > 32).any()
        # equal best candidates with different P do occur
        col = W[np.arange(32), :, sink]
        top = col.max(axis=1, keepdims=True)
        assert (((col == top) & (top > 0)).sum(axis=1) > 1).any()
        assert ((W == 0) & np.signbit(W)).any()
        assert ((W == 0) & ~np.signbit(W)).any()
    else:
        batch = tdrain.fuzz_batch(rng, 16, V)
    maxp = 32
    e = _push_drain(*batch, maxp)
    _assert_same(e, _torch(*batch, maxp))
    _assert_same(e, _host(*batch, maxp))
    _assert_same(e, _xla(*batch, maxp))
    assert e[2].sum() > 0
    if gen == "ties":
        assert (e[2][batch[2] > 0] == 0).any()      # rows with no path


def test_push_order_f32_matches_pallas_interpret():
    """The f32 instance's arithmetic: the emulation in f32 against the
    Pallas kernel in interpret mode and drain_torch in f32."""
    W, P, sink, scal = tdrain.fuzz_ties(np.random.default_rng(8), 16, 64)
    pp, wsp, npp = pallas_drain.drain_pallas(
        W, P, sink, scal[:, 0], scal[:, 1], scal[:, 2], maxp=64,
        interpret=True)
    e = _push_drain(W.astype(np.float32), P, sink, scal.astype(np.float32),
                    64)
    _assert_same(e, (pp, wsp, npp))
    _assert_same(e, _torch(W, P, sink, scal, 64, dtype=torch.float32))


def test_solver_matches_jax_solver():
    """The port's DeviceGreedyFused on the CPU returns what the JAX solver
    returns for the same staged rows, for a full and a partial wave."""
    B, V = 16, 64
    W, P, sink, scal = crossover.synth_batch(B, V, seed=7)
    W = W.copy()
    W[W >= 0] += 0.25           # non-integer weights: the f64 case
    jfd = greedy_fused.DeviceGreedyFused(batch=B, maxv=V)
    tfd = tfused.DeviceGreedyFused(batch=B, maxv=V, device=CPU)
    for fd in (jfd, tfd):
        fd.W[:], fd.P[:], fd.sink[:], fd.scal[:] = W, P, sink, scal
    for nrows in (B, 5):
        jp, jw, jn = jfd.solve(nrows)
        tp, tw, tn = tfd.solve(nrows)
        assert tp.dtype == np.bool_ and tw.dtype == np.float64
        assert tn.dtype == np.int32
        assert all(a.flags.c_contiguous for a in (tp, tw, tn))
        assert tp.shape == (nrows, tfd.maxp, V)
        _assert_same((tp, tw, tn), (jp, jw, jn))
    assert tfd.stats["fused_graphs"] == B + 5
    assert tfd.stats["fused_paths"] == int(jn.sum()) + int(
        _host(W, P, sink, scal, 64)[2].sum())


def test_batch_from_numpy_types():
    W, P, sink, scal = crossover.synth_batch(2, 8, seed=3, n_vertices=6)
    Wt, Pt, st, sc = tfused.batch_from_numpy(W, P, sink, scal, "cpu")
    assert (Wt.dtype, Pt.dtype, st.dtype, sc.dtype) == (
        torch.float64, torch.int32, torch.int32, torch.float64)
    assert np.array_equal(Wt.numpy(), W) and np.array_equal(Pt.numpy(), P)


def test_device_f64_exact(monkeypatch):
    monkeypatch.delenv("ALETSCH_FUSED_TRUST", raising=False)
    assert tfused.device_f64_exact(CPU) is True
    monkeypatch.setenv("ALETSCH_FUSED_TRUST", "0")
    assert tfused.device_f64_exact(CPU) is False
    monkeypatch.setenv("ALETSCH_FUSED_TRUST", "1")
    assert tfused.device_f64_exact(CPU) is True


def test_device_choice(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    assert port_device() == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        port_device()
    monkeypatch.delenv("ALETSCH_TORCH_DEVICE")
    with pytest.raises(RuntimeError):
        port_device()
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "meta")
    with pytest.raises(ValueError):
        port_device()


def test_wrapper_checks_inputs():
    W, P, sink, scal = tfused.batch_from_numpy(
        *crossover.synth_batch(2, 16, seed=3, n_vertices=12), CPU)
    n0 = tdrain.drain_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tdrain.drain_cuda(W, P, sink, scal, 4)
    with pytest.raises(ValueError, match="P must be"):
        tdrain.drain(W, P.long(), sink, scal, 4)
    with pytest.raises(ValueError, match="scal must be"):
        tdrain.drain(W, P, sink, scal.float(), 4)
    with pytest.raises(TypeError):
        tdrain.drain(W.half(), P, sink, scal.half(), 4)
    with pytest.raises(ValueError, match="outside"):
        big = torch.zeros((1, 65, 65), dtype=torch.float64)
        tdrain.drain(big, big.int(), sink[:1], scal[:1], 4)
    assert tdrain.drain_cuda.launches == n0


@pytest.mark.cuda
def test_drain_cuda_matches_plain_on_card():
    """The Hopper kernel against drain_torch on the card and drain_host,
    f64 bit for bit and f32 against drain_torch f32 (needs a GPU and nvcc;
    python3 chip_smoke.py runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    for batch in (tdrain.fuzz_batch(rng, 64, 64),
                  tdrain.fuzz_ties(rng, 64, 64),
                  tdrain.fuzz_ties(rng, 64, 33),
                  crossover.synth_batch(64, 64, seed=11)):
        args = tfused.batch_from_numpy(*batch, dev)
        for dt in (torch.float64, torch.float32):
            W, P, s, sc = args[0].to(dt), args[1], args[2], args[3].to(dt)
            k = [o.cpu().numpy() for o in tdrain.drain_cuda(W, P, s, sc, 64)]
            torch.cuda.synchronize()
            p = [o.cpu().numpy() for o in tdrain.drain_torch(W, P, s, sc, 64)]
            _assert_same(k, p)
            if dt == torch.float64:
                _assert_same(k, _host(*batch, 64))
                _assert_same(k, _push_drain(*batch, 64))
