"""The bridge top-K kernel's route (aletsch_tpu_torch/csrc/bridge.cu,
ops/bridge_topk.py::bridge_cuda) without a card.

The kernel's per-instance machine (csrc/bridge_machine.cuh) is built here
by the host compiler for one lane (csrc/bridge_host.cpp; several lanes in
tests/test_torch_bridge_threads.py) and held against
the plain form (bridge_plain), the JAX package's program (get_bridge_fn,
the jitted XLA program on the CPU) and the numpy oracle, element for
element, on random and tie-heavy batches at a small shape and at the
production shape, at 1, 3, 37 and 64 rows, and on edge cases: weights 0
and 999999, inserts past the stack (c >= S), more than K candidates tied
on all six keys, absent targets, a window with no edges, and the int32
wrap of the length sum and of a key's negation; and the closed-form steps
(no live in-edge, past the instance's last live vertex) against the plain
form and the machine's own step counts.  Then the dispatcher's CPU route,
the wrapper's checks, the C signatures against their ctypes declaration,
the build's hash and flags, and DeviceBridge's dispatch on a card (its
packed staging rows; one copy in, one launch over the live rows, one copy
out, one sync).  The card's own checks are the cuda-marked tests at the
end (the kernel, and the solver over a mesh of one card's devices) and
chip_smoke.py's phase 2c.  Tolerance zero: every output is int32."""

import contextlib
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


def compile_host_library(directory, extra=()):
    """csrc/bridge_host.cpp built with g++ (C++20 for std::barrier; `extra`
    flags last) into `directory`; its path.  Skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's machine for the host")
    lib = str(directory / "libbridge_host.so")
    subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", *extra, "-shared",
                    "-fPIC", "-o", lib,
                    os.path.join(_build.CSRC, "bridge_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    return lib


def declare(dll):
    """The ctypes library of bridge_host.cpp with its entries declared."""
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.aletsch_bridge_host.argtypes = _build.BRIDGE_ARGTYPES + [p, i]
    dll.aletsch_bridge_host.restype = i
    dll.aletsch_bridge_lanes_host.argtypes = [i, i, p, p]
    dll.aletsch_bridge_lanes_host.restype = i
    return dll


def build_host_library(directory):
    """compile_host_library's library, loaded and declared."""
    return declare(ctypes.CDLL(compile_host_library(directory)))


def host_runner(dll):
    """run(batch, nt=1, counts=False): numpy staging arrays through the
    machine on nt lanes; the three outputs as numpy arrays, and with
    counts the step counts ({PROF_COUNTS name: n}) beside them."""
    def run(batch, nt=1, counts=False):
        outs, c_args = BT.kernel_args(*BT.batch_from_numpy(*batch, "cpu"))
        prof = np.zeros(len(BT.PROF_PASSES) + len(BT.PROF_COUNTS), np.uint64)
        assert dll.aletsch_bridge_host(
            *c_args, prof.ctypes.data if counts else None, nt) == 0
        got = [t.numpy() for t in outs]
        if not counts:
            return got
        assert not prof[:len(BT.PROF_PASSES)].any()     # no clock here
        return got, dict(zip(BT.PROF_COUNTS,
                             prof[len(BT.PROF_PASSES):].tolist()))
    return run


@pytest.fixture(scope="module")
def host_machine(tmp_path_factory):
    """csrc/bridge_host.cpp built with g++; run(batch, nt=1, counts=False)
    takes numpy staging arrays and returns the three outputs as numpy
    arrays (host_runner)."""
    return host_runner(build_host_library(
        tmp_path_factory.mktemp("bridge_host")))


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


def _closed_form_batch():
    """Hand-made instances at V 16, E 4, T 4 whose steps take the closed
    form:
    0. vertex 2 has no in-edge, vertex 3's predecessor (2) holds no entry,
       vertex 5's is a later vertex (6, no entry yet), vertex 6 has none;
       vertices 1, 4
       and 7 take one valid candidate each; the last live in-edge is at
       vertex 7, so vertices 8 to 15 are past the instance's end;
    1. no edge at all: every step past the end;
    2. one edge, into vertex 15 from 0: vertices 1 to 14 are empty steps."""
    V, E, T = 16, 4, 4
    P = np.full((3, V, E), -1, np.int32)
    Wt = np.zeros((3, V, E), np.int32)
    Lv = np.full((3, V), 5, np.int32)
    tgt = np.array([[4, 7, 12, 2], [1, 15, -1, 3], [15, 3, 14, -1]],
                   np.int32)
    P[0, 1, 0], P[0, 3, 1], P[0, 4, 2:] = 0, 2, [3, 1]
    P[0, 5, 0], P[0, 7, 3] = 6, 4
    Wt[0, 1, 0], Wt[0, 4, 3], Wt[0, 7, 3] = 9, 4, 6
    P[2, 15, 2], Wt[2, 15, 2] = 0, 3
    return P, Wt, Lv, tgt


@pytest.mark.parametrize("nt", [1, 5])
def test_empty_steps_and_the_rows_past_the_end_are_closed_form(host_machine,
                                                                 nt):
    """A step with no live predecessor entry and the steps past the last
    vertex with a live in-edge write their rows in closed form (every
    entry invalid: parent and entry index -1, the stacks at their targets
    -1), equal to the plain form; the machine's own counts say which
    steps it ran, found empty, and never ran."""
    batch = _closed_form_batch()
    want = _plain(batch)
    _assert_same("oracle", BT.bridge_dp_host(*batch), want)
    got, counts = host_machine(batch, nt, counts=True)
    _assert_same("machine", got, want)
    assert counts == {"steps": 7 + 0 + 15, "empty_steps": 4 + 0 + 14,
                      "tail_steps": 8 + 15 + 0, "candidates": 3 + 0 + 1}
    ostk, par, pix = want
    # the vertices that hold entries from an in-edge (vertex 0 holds the
    # source's, with no parent)
    live = {0: [1, 4, 7], 1: [], 2: [15]}
    for b, vs in live.items():
        for v in range(16):
            closed = v not in vs
            assert (par[b, v] == -1).all() == closed \
                and (pix[b, v] == -1).all() == closed, (b, v)
    assert (ostk[0, 2:] == -1).all() and (ostk[0, :2, 0, 0] >= 0).all()
    assert (ostk[1] == -1).all()
    assert (ostk[2, 0, 0] == [3] + [SENTINEL] * (S - 1)).all()
    assert (ostk[2, 1:] == -1).all()


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
    V, E, T = SMALL
    assert c_args[8:12] == [V * E, V * E, V, T]
    # rows at any stride, each row contiguous: the strides go to the kernel
    wide = torch.zeros((3, 2 * V * E), dtype=torch.int32)
    wide[:, :V * E] = args[0].reshape(3, -1)
    _, c_wide = BT.kernel_args(wide[:, :V * E].unflatten(1, (V, E)),
                               *args[1:])
    assert c_wide[8] == 2 * V * E and c_wide[9:12] == c_args[9:12]
    outs2, c_outs = BT.kernel_args(*args, outs=outs)
    assert outs2 is outs and c_outs == c_args
    with pytest.raises(ValueError, match="output par"):
        BT.kernel_args(*args, outs=(outs[0], outs[1][:, :-1], outs[2]))


# -------------------------------------------- the source and the build

def test_c_signatures_match_the_ctypes_declarations():
    """aletsch_bridge_topk's parameters, parsed from bridge.cu, are the
    pointers and ints load_library declares (the stream last); its
    profiling instance takes the profile's pointer before the stream, and
    bridge_host.cpp's entry takes the profiling instance's but the stream,
    then its lanes."""
    with open(os.path.join(_build.CSRC, "bridge.cu")) as fh:
        src = fh.read()
    params = _c_params(src, "aletsch_bridge_topk")
    prof = _c_params(src, "aletsch_bridge_topk_prof")
    assert params[-1].startswith("cudaStream_t")
    assert [_ctype(p) for p in params] == _build.BRIDGE_ARGTYPES \
        + [ctypes.c_void_p]
    assert prof == params[:-1] + ["unsigned long long* prof", params[-1]]
    with open(os.path.join(_build.CSRC, "bridge_host.cpp")) as fh:
        host = _c_params(fh.read(), "aletsch_bridge_host")
    assert host == prof[:-1] + ["int nt"]
    names = [p.rsplit(None, 1)[1].lstrip("*") for p in params]
    assert names[:-1] == ["P", "Wt", "Lv", "tgt", "n", "V", "E", "T",
                          "sP", "sW", "sL", "sT", "ostk", "par", "pix"]


def test_machine_constants_are_the_ports():
    with open(os.path.join(_build.CSRC, "bridge_machine.cuh")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["K"]) == K and int(consts["S"]) == S
    assert int(consts["SENTINEL"]) == SENTINEL
    assert consts["BIG"] == "1 << 30" and int(BT.BIG) == 1 << 30


def test_profile_names_follow_the_machines_counters():
    """bridge_profile names the profiling instance's counters in the order
    of csrc/bridge_machine.cuh's PROF_* enum: the passes, then the
    counts."""
    with open(os.path.join(_build.CSRC, "bridge_machine.cuh")) as fh:
        src = fh.read()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"PROF_(\w+)", body) == [
        "LOAD", "BUILD", "SELECT", "WRITE", "EMPTY", "OUT", "STEPS",
        "NEMPTY", "TAIL", "CANDS"]
    assert [p.upper() for p in BT.PROF_PASSES] == [
        "LOAD", "BUILD", "SELECT", "WRITE", "EMPTY", "OUT"]
    assert BT.PROF_COUNTS == ("steps", "empty_steps", "tail_steps",
                              "candidates")
    assert body.rstrip().endswith("NPROF")


def test_bridge_source_and_header_are_in_the_build_hash(monkeypatch):
    assert "bridge.cu" in _build.SOURCES
    assert "bridge_machine.cuh" in _build.HEADERS
    assert "team.cuh" in _build.HEADERS
    assert "bridge.cu" not in _build.SOURCE_FLAGS
    flags = " ".join(_build.NVCC_FLAGS) + " ".join(
        " ".join(f) for f in _build.SOURCE_FLAGS.values())
    assert "fast_math" not in flags and "fast-math" not in flags
    base, headers = _build.library_path(), _build.HEADERS
    for name in ("bridge_machine.cuh", "team.cuh"):
        monkeypatch.setattr(_build, "HEADERS", tuple(
            h for h in headers if h != name))
        assert _build.library_path() != base
    monkeypatch.setattr(_build, "HEADERS", headers)
    assert _build.library_path() == base


# --------------------------------------------- the solver on a card

def _staged_solver(B, batch, device="cpu"):
    solver = BT.DeviceBridge(batch=B, maxv=16, maxe=4, maxt=4,
                             device=device)
    for i in range(B):
        for dst, src in zip(solver.row(i), batch):
            dst[...] = src[i]
    return solver


@pytest.mark.parametrize("nrows", [1, 5, 8])
def test_solver_on_a_card_launches_once_over_the_live_rows(monkeypatch,
                                                           nrows):
    """DeviceBridge with its device switched to a card (tensors stay on
    the CPU here): a dispatch is one host-to-device copy of exactly the
    nrows live packed rows into the card's input buffer, one launch of the
    kernel's entry over strided views of it, writing the three outputs
    into one device buffer, one device-to-host copy of that buffer into the
    pinned one and one sync; the results are C-contiguous int32 host
    arrays of nrows rows and of their own, and a second dispatch of as
    many rows checks and builds nothing again."""
    B = 8
    batch = BT.fuzz_batch(np.random.default_rng(nrows), B, *SMALL,
                          ties=True)
    solver = _staged_solver(B, batch)
    log = []
    plain, checks = BT.bridge_plain, BT.kernel_args

    def fake_launch(c_args, dev, prof=None, stream=None):
        """The kernel's results, from the plain form, written where the
        launch's pointers say."""
        assert prof is None and dev.type == "cuda"
        assert isinstance(stream, Stream)
        (dpacked, buf, _), = [p for p in solver._plans.values()
                              if p[2] is c_args]
        rows = dpacked.shape[0]
        log.append(("launch", rows))
        views = BT.input_views(dpacked, solver.layout)
        assert c_args[:4] == [v.data_ptr() for v in views]
        # rows a packed row apart (one row has no stride to speak of)
        assert rows == 1 or c_args[8:12] == [solver.row_bytes // 4] * 4
        for p, g in zip(c_args[12:15], plain(*views)):
            at = (p - buf.data_ptr()) // 4
            copy(buf[at:at + g.numel()], g.reshape(-1))
        BT.bridge_cuda.launches += 1

    def counted_checks(*a, **k):
        log.append("checks")
        return checks(*a, **k)

    to, copy, empty = torch.Tensor.to, torch.Tensor.copy_, torch.empty
    out_ptr = solver._out.data_ptr()

    def to_card(self, *a, **k):
        if a and isinstance(a[0], torch.device) and a[0].type == "cuda":
            log.append(("to card", tuple(self.shape)))
            return self
        return to(self, *a, **k)

    def logged_copy(self, src, non_blocking=False):
        cards = [c[0].data_ptr() for c in solver._cards.values()]
        if self.data_ptr() in cards:
            log.append(("h2d", tuple(src.shape), non_blocking))
        elif self.data_ptr() == out_ptr:
            log.append(("d2h", src.numel(), non_blocking))
        return copy(self, src, non_blocking)

    def empty_on_card(*a, device=None, **k):
        return empty(*a, **k)

    class Stream:
        def synchronize(self):
            log.append("sync")

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            pass

        def elapsed_time(self, end):
            return 0.125

    solver.device = torch.device("cuda")
    monkeypatch.setattr(BT, "launch", fake_launch)
    monkeypatch.setattr(BT, "kernel_args", counted_checks)
    monkeypatch.setattr(torch.Tensor, "to", to_card)
    monkeypatch.setattr(torch.Tensor, "copy_", logged_copy)
    monkeypatch.setattr(torch, "empty", empty_on_card)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    out_row = 4 * K * S + 2 * 16 * K
    dispatch = [("h2d", (nrows, solver.row_bytes), True), ("launch", nrows),
                ("d2h", nrows * out_row, True), "sync"]
    want = BT.bridge_dp_host(*(a[:nrows] for a in batch))
    for first in (True, False):
        del log[:]
        got = solver.solve(nrows)
        assert log == (["checks"] if first else []) + dispatch
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.flags["C_CONTIGUOUS"]
            assert g.shape[0] == nrows and np.array_equal(g, w)
            assert not np.shares_memory(g, solver._out.numpy())
            assert not np.shares_memory(g, solver._packed.numpy())
    assert solver.stats["bridge_launches"] == 2
    assert solver.stats["bridge_dispatches"] == 2
    assert solver.stats["bridge_instances"] == 2 * nrows
    assert solver.stats["bridge_kernel_time"] == 2 * 0.125e-3


def test_packed_rows_are_the_staging_arrays_field_by_field():
    """The solver's one staging buffer: P, Wt, Lv and tgt each at a 16-byte
    aligned offset of a row of its own bytes, numpy views of it, filled
    with the absent values; the kernel's four inputs int32 views of the
    same bytes that equal the staged arrays; the plain form over the views
    equals the plain form over the arrays."""
    B = 8
    batch = BT.fuzz_batch(np.random.default_rng(4), 6, *SMALL)
    solver = BT.DeviceBridge(batch=B, maxv=16, maxe=4, maxt=4, device="cpu")
    assert (solver.P == -1).all() and (solver.tgt == -1).all()
    assert not solver.Wt.any() and not solver.Lv.any()
    for i in range(6):
        for dst, src in zip(solver.row(i), batch):
            dst[...] = src[i]
    layout, R = BT.packed_layout(16, 4, 4)
    assert R == solver.row_bytes and R % BT.ALIGN == 0
    assert solver._packed.shape == (B, R)
    assert solver._packed.dtype == torch.uint8
    assert [f[0] for f in layout] == ["P", "Wt", "Lv", "tgt"]
    end = 0
    base = solver._packed.numpy().ctypes.data
    for (name, shape, off, _), got in zip(layout, solver.row(3)):
        assert off % BT.ALIGN == 0 and off >= end, name
        end = off + int(np.prod(shape)) * 4
        view = getattr(solver, name)
        assert view.dtype == np.int32 and view.shape == (B,) + shape, name
        assert view.strides[0] == R and view[0].flags["C_CONTIGUOUS"]
        assert view.ctypes.data == base + off, name
        assert got.ctypes.data == base + 3 * R + off, name
    assert end <= R
    views = BT.input_views(solver._packed[:6], layout)
    want = BT.batch_from_numpy(*batch, "cpu")
    for v, w in zip(views, want):
        assert v.dtype == w.dtype and v.shape == w.shape
        assert torch.equal(v, w)
        assert v.untyped_storage().data_ptr() == \
            solver._packed.untyped_storage().data_ptr()
    _assert_same("views", [t.numpy() for t in BT.bridge_plain(*views)],
                 _plain(batch))
    # the kernel takes these views as they are, an instance a row apart
    _, c_args = BT.kernel_args(*views)
    assert c_args[8:12] == [R // 4] * 4
    got = solver.solve(6)
    _assert_same("solve on the CPU", got, _plain(batch))
    for g in got:
        assert g.flags["C_CONTIGUOUS"]
        assert not np.shares_memory(g, solver._packed.numpy())


def test_solver_over_an_emulated_mesh_equals_one_device(monkeypatch):
    """DeviceBridge over two and three CPU devices (the split and the
    replicated branch of ops/meshing.py) equals one device, with the mesh
    bytes accounted; the same check on the card is the cuda-marked test
    below and chip_smoke.py's phase 2c."""
    from aletsch_tpu_torch.ops import meshing
    B = 8
    batch = BT.fuzz_batch(np.random.default_rng(6), B, *SMALL, ties=True)
    want = _staged_solver(B, batch).solve(6)
    for n in (2, 3):
        monkeypatch.setattr(meshing, "_local_devices",
                            lambda d, n=n: [d] * n)
        solver = _staged_solver(B, batch)
        _assert_same("%d devices" % n, solver.solve(6), want)
        st = solver.stats
        assert st["mesh_devices"] == n and st["mesh_dispatches"] == 1
        assert st["mesh_bytes_in"] == 6 * solver.row_bytes
        assert st["mesh_bytes_out"] == sum(w.nbytes for w in want)


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


@pytest.mark.cuda
def test_bridge_solver_over_a_mesh_of_cards(monkeypatch):
    """DeviceBridge.solve on the card with the mesh emulated as two and as
    three cuda:0 devices (ops/meshing.py's split and replicated branches)
    at 1, 3, 37 and 64 rows == one device, bit for bit: one kernel launch
    a shard, the mesh's bytes in and out accounted (needs a GPU and nvcc;
    chip_smoke.py's phase 2c runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from aletsch_tpu_torch.ops import meshing
    batch = BT.fuzz_batch(np.random.default_rng(9), 64, ties=True)

    def staged():
        solver = BT.DeviceBridge(device="cuda")
        for dst, src in zip((solver.P, solver.Wt, solver.Lv, solver.tgt),
                            batch):
            dst[...] = src
        return solver
    one = staged()
    want = {rows: one.solve(rows) for rows in (1, 3, 37, 64)}
    for n in (2, 3):
        monkeypatch.setattr(meshing, "_local_devices",
                            lambda d, n=n: [torch.device("cuda", 0)] * n)
        solver = staged()
        for rows, w in want.items():
            n0 = BT.bridge_cuda.launches
            got = solver.solve(rows)
            assert BT.bridge_cuda.launches == n0 + n, (n, rows)
            _assert_same("%d devices, %d rows" % (n, rows), got, w)
        st = solver.stats
        assert st["mesh_devices"] == n and st["mesh_dispatches"] == 4
        assert st["bridge_launches"] == 4 * n
        assert st["mesh_bytes_in"] == sum(want) * solver.row_bytes
        assert st["mesh_bytes_out"] == sum(
            a.nbytes for w in want.values() for a in w)
