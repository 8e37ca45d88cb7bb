"""The bridge top-K kernel's route (aletsch_tpu_torch/csrc/bridge.cu,
ops/bridge_topk.py::bridge_cuda) without a card.

The kernel's per-instance machine (csrc/bridge_machine.cuh) is built here
by the host compiler for one thread (csrc/bridge_host.cpp) and held against
the plain form (bridge_plain), the JAX package's program (get_bridge_fn,
the jitted XLA program on the CPU) and the numpy oracle, element for
element, on random and tie-heavy batches at a small shape and at the
production shape, at 1, 3, 37 and 64 rows, and on edge cases: weights 0
and 999999, inserts past the stack (c >= S), more than K candidates tied
on all six keys, absent targets, a window with no edges, and the int32
wrap of the length sum and of a key's negation.  Then the dispatcher's CPU
route, the wrapper's checks, the C signatures against their ctypes
declaration, the build's hash and flags, and DeviceBridge on a card (one
launch a dispatch over the live rows only).  The card's own check is the
cuda-marked test at the end and chip_smoke.py's phase 2c.  Tolerance
zero: every output is int32."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import bridge_topk as ref
from aletsch_tpu_torch.ops import _build
from aletsch_tpu_torch.ops import bridge_topk as BT
from aletsch_tpu_torch.ops.bridge_topk import K, S, SENTINEL
from test_torch_ladder_kernel import _c_params, _changed, _ctype

NAMES = ("ostk", "par", "pix")
SMALL = (16, 4, 4)
FULL = (BT.DEFAULT_V, BT.DEFAULT_E, BT.DEFAULT_T)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def host_machine(tmp_path_factory):
    """csrc/bridge_host.cpp built with g++ for one thread; run(batch) takes
    numpy staging arrays and returns the three outputs as numpy arrays."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's machine for the host")
    lib = str(tmp_path_factory.mktemp("bridge_host") / "libbridge_host.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-o", lib,
                    os.path.join(_build.CSRC, "bridge_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(lib).aletsch_bridge_host
    fn.argtypes = _build.BRIDGE_ARGTYPES
    fn.restype = ctypes.c_int

    def run(batch):
        outs, c_args = BT.kernel_args(*BT.batch_from_numpy(*batch, "cpu"))
        assert fn(*c_args) == 0
        return [t.numpy() for t in outs]
    return run


def _plain(batch):
    return [t.numpy() for t in BT.bridge_plain(
        *BT.batch_from_numpy(*batch, "cpu"))]


def _jax(batch):
    V, E = batch[0].shape[1:]
    return [np.asarray(x) for x in
            ref.get_bridge_fn(V, E, batch[3].shape[1])(*batch)]


def _assert_same(tag, got, want):
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == w.dtype == np.int32, (tag, name)
        assert g.shape == w.shape and np.array_equal(g, w), (tag, name)


# ------------------------------------- the machine against the references

_REFS = {}


def _fuzz(kind):
    """A 64-row batch and its references (plain form, JAX program, numpy
    oracle), made once."""
    if kind not in _REFS:
        seed, shape, ties = {
            "random, small shape": (20, SMALL, False),
            "tie-heavy, small shape": (21, SMALL, True),
            "random, production shape": (22, FULL, False),
            "tie-heavy, production shape": (23, FULL, True)}[kind]
        batch = BT.fuzz_batch(np.random.default_rng(seed), 64, *shape,
                              ties=ties)
        want = _plain(batch)
        _assert_same(kind + ": JAX", _jax(batch), want)
        _assert_same(kind + ": oracle", BT.bridge_dp_host(*batch), want)
        _REFS[kind] = batch, want
    return _REFS[kind]


@pytest.mark.parametrize("rows", [1, 3, 37, 64])
@pytest.mark.parametrize("kind", ["random, small shape",
                                  "tie-heavy, small shape",
                                  "random, production shape",
                                  "tie-heavy, production shape"])
def test_host_built_machine_equals_plain_jax_and_oracle(host_machine, kind,
                                                        rows):
    """The first `rows` instances through the machine == their rows of the
    plain form, the JAX program and the numpy oracle (rows are
    independent in all three), and the plain form on those rows alone."""
    batch, want = _fuzz(kind)
    sub = [a[:rows] for a in batch]
    got = host_machine(sub)
    _assert_same(kind, got, [w[:rows] for w in want])
    _assert_same(kind + ", alone", got, _plain(sub))
    if rows == 64:
        ostk, par = got[0], got[1]
        assert (ostk[:, :, 0, 0] >= 0).any() and (par >= 0).any()
        if "tie-heavy" in kind:
            # some target keeps two entries that only position separates
            same = (ostk[:, :, 0] == ostk[:, :, 1]).all(axis=-1) \
                & (ostk[:, :, 0, 0] >= 0)
            assert same.any()


def _edge_batch():
    """Hand-made instances at V 16, E 16, T 4 (rows):
    0. parallel edges: vertex 1 takes ten edges of weight 5 from vertex 0,
       so it holds K entries equal in every key; vertex 2 takes two edges
       of weight 5 from vertex 1, twenty candidates tied on all six keys,
       of which position keeps e = 0; vertex 3 adds a third edge;
    1. weights 0 and 999999 (an insert at c = S leaves the stack as it
       is) along a chain with a shortcut;
    2. a window with no edges: every target absent or unreachable;
    3. a mixed window whose targets include -1 and an unreachable vertex,
       and an in-edge row with gaps between the live slots."""
    V, E, T = 16, 16, 4
    P = np.full((4, V, E), -1, np.int32)
    Wt = np.zeros((4, V, E), np.int32)
    Lv = np.full((4, V), 3, np.int32)
    tgt = np.full((4, T), -1, np.int32)
    P[0, 1, :10] = 0
    Wt[0, 1, :10] = 5
    P[0, 2, :2] = 1
    Wt[0, 2, :2] = 5
    P[0, 3, :3] = [2, 1, 2]
    Wt[0, 3, :3] = [5, 0, 999999]
    tgt[0] = [1, 2, 3, -1]
    for k in range(1, 8):
        P[1, k, 0] = k - 1
        Wt[1, k, 0] = (0, SENTINEL)[k % 2]
    P[1, 5, 1], Wt[1, 5, 1] = 2, SENTINEL
    P[1, 7, 1], Wt[1, 7, 1] = 0, 0
    tgt[1] = [7, 5, 3, 1]
    tgt[2] = [1, 5, 15, -1]
    P[3, 2, [0, 3, 7]] = [0, 1, 0]
    Wt[3, 2, [0, 3, 7]] = [4, 4, 4]
    P[3, 1, 5] = 0
    Wt[3, 1, 5] = 4
    P[3, 6, 0] = 2
    tgt[3] = [-1, 6, 9, 2]
    return P, Wt, Lv, tgt


def test_edge_cases_equal_plain_jax_and_oracle(host_machine):
    batch = _edge_batch()
    want = _plain(batch)
    _assert_same("JAX", _jax(batch), want)
    _assert_same("oracle", BT.bridge_dp_host(*batch), want)
    _assert_same("machine", host_machine(batch), want)
    ostk, par, pix = want
    # row 0: K entries tied on every key at vertices 1 to 3, kept in
    # candidate order: vertex 2's all come from in-edge slot 0
    assert (ostk[0, :3, :, 0] == 5).all()
    assert (par[0, 2] == 1).all() and pix[0, 2].tolist() == list(range(K))
    # row 1: an edge of 999999 leaves the stack as it is (c = S), one of 0
    # enters it; vertex 1 keeps the sentinel stack
    assert set(np.unique(ostk[1]).tolist()) == {-1, 0, SENTINEL}
    assert ostk[1, 3, 0].tolist() == [SENTINEL] * S
    assert ostk[1, 0, 0].tolist() == [0] + [SENTINEL] * (S - 1)
    # row 2: no edges, nothing reachable
    assert (ostk[2] == -1).all() and (par[2] == -1).all()
    # row 3: absent and unreachable targets read -1
    assert (ostk[3, [0, 2]] == -1).all() and (ostk[3, 3, :2, 0] == 4).all()


def test_int32_wrap_equals_plain_and_jax(host_machine):
    """Lengths near 2^31 (the sum wraps), and weights whose negation wraps
    (-2^31) or whose key ties or passes an absent candidate's BIG (-2^30
    and below), where absent candidates sort ahead of valid ones: the
    machine == the plain form == the JAX program.  The numpy oracle adds
    and negates Python ints, which do not wrap, so it is not asked."""
    rng = np.random.default_rng(8)
    P, Wt, Lv, tgt = BT.fuzz_batch(rng, 16, *SMALL)
    Lv[:8] = rng.integers(2**30, 2**31 - 1, size=Lv[:8].shape)
    live = P[8:] >= 0
    Wt[8:] = np.where(live, rng.choice(
        np.array([-2**31, -2**30 - 1, -2**30, -5, 0, 7], np.int32),
        size=Wt[8:].shape), 0)
    batch = (P, Wt, Lv, tgt)
    want = _plain(batch)
    _assert_same("JAX", _jax(batch), want)
    _assert_same("machine", host_machine(batch), want)
    assert (want[0][:8, :, :, 0] >= 0).any()
    assert (want[1][8:] >= 0).any()


def test_no_rows(host_machine):
    batch = [a[:0] for a in BT.fuzz_batch(np.random.default_rng(0), 1,
                                          *SMALL)]
    got = host_machine(batch)
    assert [g.shape for g in got] == [(0, 4, K, S), (0, 16, K), (0, 16, K)]


# -------------------------------------- the dispatcher and the wrapper

def _args(n=3, shape=SMALL):
    batch = BT.fuzz_batch(np.random.default_rng(1), n, *shape)
    return BT.batch_from_numpy(*batch, "cpu")


def test_cpu_tensors_never_touch_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(_build, "load_library", refuse)
    n0 = BT.bridge_cuda.launches
    args = _args()
    _assert_same("bridge_dp()", [t.numpy() for t in BT.bridge_dp(*args)],
                 [t.numpy() for t in BT.bridge_plain(*args)])
    assert BT.bridge_cuda.launches == n0


def test_tensors_off_the_cpu_go_to_the_kernel_and_never_fall_back(
        monkeypatch):
    """bridge_dp() sends any tensor not on the CPU (here on the meta
    device) to bridge_cuda, never to the plain form; bridge_cuda itself
    refuses what is not on a card rather than run it elsewhere."""
    meta = tuple(a.to("meta") for a in _args())
    with pytest.raises(ValueError, match="CUDA tensors"):
        BT.bridge_dp(*meta)
    calls = []

    def refuse(*a):
        raise AssertionError("card tensors took the plain form")
    monkeypatch.setattr(BT, "bridge_plain", refuse)
    monkeypatch.setattr(BT, "bridge_cuda", lambda *a: calls.append(a))
    BT.bridge_dp(*meta)
    assert calls == [meta]


def test_bridge_cuda_refuses_what_the_kernel_does_not_take():
    args = _args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        BT.bridge_cuda(*args)
    cases = [
        (0, args[0].to(torch.int64), "P must be"),
        (1, args[1][:, :-1], "Wt must be"),
        (2, args[2].to(torch.float32), "Lv must be"),
        (3, args[3][:-1], "tgt must be"),
        (1, args[1].transpose(1, 2).contiguous().transpose(1, 2),
         "Wt must be contiguous"),
        (3, args[3].t().contiguous().t(), "tgt must be contiguous"),
        (2, args[2].to("meta"), "Lv is on meta"),
        (0, args[0][:, :, None], "P must be"),
    ]
    for i, t, msg in cases:
        with pytest.raises(ValueError, match=msg):
            BT.kernel_args(*_changed(args, i, t))
    with pytest.raises(ValueError, match="V and E"):
        BT.kernel_args(*(a[:, :0] for a in args[:2]), args[2][:, :0],
                       args[3])
    outs, c_args = BT.kernel_args(*args)
    assert [tuple(t.shape) for t in outs] == [
        tuple(t.shape) for t in BT.bridge_plain(*args)]
    assert all(t.dtype == torch.int32 for t in outs)
    assert len(c_args) == len(_build.BRIDGE_ARGTYPES)
    assert c_args[4:8] == [3, *SMALL]


# -------------------------------------------- the source and the build

def test_c_signatures_match_the_ctypes_declarations():
    """aletsch_bridge_topk's parameters, parsed from bridge.cu, are the
    pointers and ints load_library declares (the stream last), and
    bridge_host.cpp's entry takes the same but the stream."""
    with open(os.path.join(_build.CSRC, "bridge.cu")) as fh:
        params = _c_params(fh.read(), "aletsch_bridge_topk")
    assert params[-1].startswith("cudaStream_t")
    assert [_ctype(p) for p in params] == _build.BRIDGE_ARGTYPES \
        + [ctypes.c_void_p]
    with open(os.path.join(_build.CSRC, "bridge_host.cpp")) as fh:
        host = _c_params(fh.read(), "aletsch_bridge_host")
    assert host == params[:-1]
    names = [p.rsplit(None, 1)[1].lstrip("*") for p in params]
    assert names[:-1] == ["P", "Wt", "Lv", "tgt", "n", "V", "E", "T",
                          "ostk", "par", "pix"]


def test_machine_constants_are_the_ports():
    with open(os.path.join(_build.CSRC, "bridge_machine.cuh")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["K"]) == K and int(consts["S"]) == S
    assert int(consts["SENTINEL"]) == SENTINEL
    assert consts["BIG"] == "1 << 30" and int(BT.BIG) == 1 << 30


def test_bridge_source_and_header_are_in_the_build_hash(monkeypatch):
    assert "bridge.cu" in _build.SOURCES
    assert "bridge_machine.cuh" in _build.HEADERS
    assert "bridge.cu" not in _build.SOURCE_FLAGS
    flags = " ".join(_build.NVCC_FLAGS) + " ".join(
        " ".join(f) for f in _build.SOURCE_FLAGS.values())
    assert "fast_math" not in flags and "fast-math" not in flags
    base = _build.library_path()
    monkeypatch.setattr(_build, "HEADERS", ("ladder_machine.cuh",))
    assert _build.library_path() != base
    monkeypatch.setattr(_build, "HEADERS", _build.HEADERS + (
        "bridge_machine.cuh",))
    assert _build.library_path() == base


# --------------------------------------------- the solver on a card

@pytest.mark.parametrize("nrows", [1, 5, 8])
def test_solver_on_a_card_launches_once_over_the_live_rows(monkeypatch,
                                                           nrows):
    """DeviceBridge with its device switched to a card (tensors stay on
    the CPU here): a dispatch is one call of the dispatcher bridge_dp(),
    which sends a card's tensors to the kernel (the test above), over
    exactly the nrows live rows, and its outputs come back as
    C-contiguous int32 host arrays of nrows rows."""
    B = 8
    batch = BT.fuzz_batch(np.random.default_rng(nrows), B, *SMALL,
                          ties=True)
    solver = BT.DeviceBridge(batch=B, maxv=16, maxe=4, maxt=4, device="cpu")
    for i in range(B):
        for dst, src in zip(solver.row(i), batch):
            dst[...] = src[i]
    calls = []
    plain = BT.bridge_plain

    def fake_kernel(*a):
        calls.append(a[0].shape[0])
        BT.bridge_cuda.launches += 1
        return plain(*a)

    to = torch.Tensor.to

    def stay_on_cpu(self, *a, **k):
        if a and isinstance(a[0], torch.device) and a[0].type == "cuda":
            return self
        return to(self, *a, **k)

    solver.device = torch.device("cuda")
    monkeypatch.setattr(BT, "bridge_dp", fake_kernel)
    monkeypatch.setattr(torch.Tensor, "to", stay_on_cpu)
    n0 = BT.bridge_cuda.launches
    for _ in range(2):
        got = solver.solve(nrows)
        for g, w in zip(got, BT.bridge_dp_host(*(a[:nrows] for a in batch))):
            assert g.dtype == np.int32 and g.flags["C_CONTIGUOUS"]
            assert g.shape[0] == nrows and np.array_equal(g, w)
    assert calls == [nrows, nrows]
    assert BT.bridge_cuda.launches == n0 + 2
    assert solver.stats["bridge_launches"] == 2
    assert solver.stats["bridge_dispatches"] == 2
    assert solver.stats["bridge_instances"] == 2 * nrows


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
def test_bridge_kernel_matches_plain_on_card():
    """bridge_cuda against bridge_plain on the host CPU at the production
    shape, random and tie-heavy, at 1, 3, 37 and 64 rows, one launch a
    call (needs a GPU and nvcc; python3 chip_smoke.py runs the full
    check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for ties in (False, True):
        batch = BT.fuzz_batch(np.random.default_rng(3), 64, ties=ties)
        want = _plain(batch)
        on_card = BT.batch_from_numpy(*batch, "cuda")
        for rows in (1, 3, 37, 64):
            n0 = BT.bridge_cuda.launches
            got = BT.bridge_dp(*(a[:rows] for a in on_card))
            torch.cuda.synchronize()
            assert BT.bridge_cuda.launches == n0 + 1
            _assert_same("card", [t.cpu().numpy() for t in got],
                         [w[:rows] for w in want])
