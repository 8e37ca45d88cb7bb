"""The ladder kernel's route (aletsch_tpu_torch/csrc/ladder.cu,
ops/ladder_kernel.py::ladder_cuda) without a card.

The kernel runs each graph to its own end, where the plain loop advances
the whole batch in lockstep: these tests pin the independence that relies
on (a row run alone equals its row of the batch, at the iteration cap
too, and both equal the JAX package's program), the per-graph event counts
the kernel reports, the dispatcher's CPU route, the wrapper's checks, the
C signature against its ctypes declaration, the build's flags, and the
solver's dispatch (its packed staging rows, one copy in, one launch, one
copy out).  The kernel's per-graph machine (csrc/ladder_machine.cuh) is
also built here by the host compiler (csrc/ladder_host.cpp) and held, on
one thread, against the plain form, bit for bit, on seeded states, the
ladder fixtures and shapes that force every overflow
(tests/test_torch_ladder_threads.py runs it on several).  The card's own
check is the cuda-marked test at the end and chip_smoke.py's phase 2c."""

import contextlib
import ctypes
import math
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import ladder_kernel as ref_kernel
from aletsch_tpu_torch.ops import _build, ladder_device
from aletsch_tpu_torch.ops import ladder_kernel as LK
from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
from test_torch_ladder import FIX_KW, KW, LADDER, SHAPE

NAMES = LK.OUT_NAMES + ("events",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_same(tag, got, want):
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, name)
        assert np.array_equal(_bits(g), _bits(w)), (tag, name)


def _args(seeds, shape=SHAPE):
    _, states = LK.fuzz_states(seeds, **shape)
    arr = LK.pack_states(states, len(states), **shape)
    return arr, LK.batch_from_numpy(arr, "cpu")


def _jax(arr, kw, maxiter):
    """The JAX package's program on the same packed arrays."""
    import jax
    B = len(arr["nv"])
    fn = ref_kernel.get_ladder_fn(B, kw["V"], kw["E"], kw["H"], kw["L"],
                                  kw["DMAX"], kw["DLOG"], maxiter)
    with jax.enable_x64():
        import jax.numpy as jnp
        out = fn(*[jnp.asarray(arr[k]) for k in LK.ARG_NAMES])
        return [np.asarray(o) for o in out]


# ------------------------------------------- (a), (b): independent graphs

@pytest.mark.parametrize("seeds, maxiter", [
    (range(0, 25), None), (range(25, 50), None), (range(0, 25), 17)])
def test_rows_alone_equal_the_batch_and_the_jax_program(seeds, maxiter):
    """Every row run alone through the plain loop equals its row of the
    batch in all 13 outputs and its event count, ewrt on int64 views; at
    a small cap, where graphs still running read out as OVERFLOW, too.
    The batch equals the JAX package's program on the same arrays."""
    arr, args = _args(seeds)
    kw = dict(DMAX=KW["DMAX"], DLOG=KW["DLOG"], maxiter=maxiter)
    batch = LK.ladder_plain(*args, with_events=True, **kw)
    B = len(arr["nv"])
    assert B > 10
    for b in range(B):
        alone = LK.ladder_plain(*(a[b:b + 1] for a in args),
                                with_events=True, **kw)
        _assert_same("row %d" % b, [t[b:b + 1] for t in batch], alone)
    status = batch[3].numpy()
    if maxiter is None:
        assert (status == LK.ST_CLEAN).any()
    else:
        # the cap cuts the longer graphs, not all of them
        assert (status == LK.ST_OVERFLOW).any()
        assert (batch[-1].numpy() < maxiter).any()
    want = _jax(arr, KW, 4 * KW["V"] ** 2 if maxiter is None else maxiter)
    for name, g, w in zip(LK.OUT_NAMES, batch, want):
        assert np.array_equal(_bits(g), w.view(np.int64)
                              if w.dtype == np.float64 else w), name


@pytest.mark.parametrize("maxiter", [None, 3])
def test_largest_event_count_is_the_lockstep_iteration_count(maxiter):
    """The per-graph event counts the kernel reports: their largest is
    the number of steps the plain loop takes, what ladder_iterations
    counts; a graph that starts done (nv = 0) counts none."""
    _, states = LK.fuzz_states(range(50, 62), **SHAPE)
    arr = LK.pack_states([None] + states, len(states) + 1, **SHAPE)
    counters = {"ladder_iterations": 5}
    out = LK.ladder_plain(*LK.batch_from_numpy(arr, "cpu"), DMAX=KW["DMAX"],
                          DLOG=KW["DLOG"], maxiter=maxiter,
                          counters=counters, with_events=True)
    events = out[-1].numpy()
    assert events.dtype == np.int32 and events[0] == 0
    assert counters["ladder_iterations"] == 5 + events.max() > 5
    if maxiter is None:
        assert len(set(events[1:].tolist())) > 1   # graphs end apart
    else:
        assert events.max() == maxiter


# -------------------------------------- (c): the dispatcher and the wrapper

def test_cpu_tensors_never_touch_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU route loaded the kernel library")
    monkeypatch.setattr(_build, "load_library", refuse)
    n0 = LK.ladder_cuda.launches
    _, args = _args(range(3))
    kw = dict(DMAX=KW["DMAX"], DLOG=KW["DLOG"])
    got = LK.ladder(*args, with_events=True, **kw)
    _assert_same("ladder()", got, LK.ladder_plain(*args, with_events=True,
                                                  **kw))
    assert len(LK.ladder(*args, **kw)) == 13
    assert LK.ladder_cuda.launches == n0


def test_tensors_off_the_cpu_go_to_the_kernel_and_never_fall_back(
        monkeypatch):
    """ladder() sends any tensor not on the CPU (here on the meta device)
    to ladder_cuda, never to the plain loop; ladder_cuda itself refuses
    what is not on a card rather than run it elsewhere."""
    _, args = _args(range(3))
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        LK.ladder(*meta)
    calls = []

    def refuse(*a, **k):
        raise AssertionError("card tensors took the plain loop")
    monkeypatch.setattr(LK, "ladder_plain", refuse)
    monkeypatch.setattr(LK, "ladder_cuda",
                        lambda *a, **k: calls.append((a, k)))
    LK.ladder(*meta, DMAX=5, DLOG=7, counters={})
    assert len(calls) == 1 and calls[0][0] == meta
    assert calls[0][1] == dict(DMAX=5, DLOG=7, counters={})


def _changed(args, i, t):
    return tuple(t if j == i else a for j, a in enumerate(args))


def test_ladder_cuda_refuses_what_the_kernel_does_not_take():
    _, args = _args(range(3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        LK.ladder_cuda(*args)
    # the checks every launch passes first, on any device
    cases = [
        (2, args[2].to(torch.float32), "ewrt must be"),
        (0, args[0].to(torch.int64), "esrc must be"),
        (6, args[6].to(torch.uint8), "ealive must be"),
        (9, args[9].to(torch.uint8), "nz must be"),
        (11, args[11][:, :-1], "hlen must be"),
        (10, args[10].transpose(1, 2).contiguous().transpose(1, 2),
         "hedge must be contiguous"),
        (11, args[11].t().contiguous().t(), "hlen must be contiguous"),
        (13, args[13][:-1], "jump must be"),
    ]
    for i, t, msg in cases:
        with pytest.raises(ValueError, match=msg):
            LK.kernel_args(_changed(args, i, t), DMAX=KW["DMAX"],
                           DLOG=KW["DLOG"])
    with pytest.raises(TypeError):
        LK.kernel_args(args[:-1])
    with pytest.raises(ValueError, match="DMAX"):
        LK.kernel_args(args, DMAX=257, DLOG=KW["DLOG"])
    outs, c_args = LK.kernel_args(args, DMAX=KW["DMAX"], DLOG=KW["DLOG"])
    assert [t.dtype for t in outs] == [t.dtype for t in LK.ladder_plain(
        *args, DMAX=KW["DMAX"], DLOG=KW["DLOG"], maxiter=0,
        with_events=True)]
    assert len(c_args) == len(_build.LADDER_ARGTYPES)
    assert c_args[17:25] == [len(args[0]), KW["V"], KW["E"], KW["H"],
                             KW["L"], KW["DMAX"], KW["DLOG"],
                             4 * KW["V"] ** 2]


# -------------------------------------------- (d): the source and the build

def _c_params(src, fn):
    m = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % fn, src, re.S)
    assert m, fn
    return [p.strip() for p in m.group(1).split(",")]


def _ctype(param):
    decl = param.rsplit(None, 1)[0]
    return ctypes.c_void_p if "*" in decl or decl == "cudaStream_t" \
        else ctypes.c_int


def test_c_signatures_match_the_ctypes_declarations():
    """aletsch_ladder_f64's parameters, parsed from ladder.cu, are the
    pointers and ints load_library declares (the stream last), and
    ladder_host.cpp's entry takes the same but the stream."""
    with open(os.path.join(_build.CSRC, "ladder.cu")) as fh:
        params = _c_params(fh.read(), "aletsch_ladder_f64")
    assert params[-1].startswith("cudaStream_t")
    assert [_ctype(p) for p in params] == _build.LADDER_ARGTYPES \
        + [ctypes.c_void_p]
    with open(os.path.join(_build.CSRC, "ladder_host.cpp")) as fh:
        host = _c_params(fh.read(), "aletsch_ladder_host")
    assert host == params[:-1] + ["int nt"]
    names = [p.rsplit(None, 1)[1].lstrip("*") for p in params]
    assert names[:17] == list(LK.ARG_NAMES)
    assert names[17:25] == ["B", "V", "E", "H", "L", "DMAX", "DLOG",
                            "maxiter"]


def test_ladder_source_and_flags_are_in_the_build_hash(monkeypatch):
    assert "ladder.cu" in _build.SOURCES
    assert "ladder_machine.cuh" in _build.HEADERS
    assert "ladder_block.cuh" in _build.HEADERS
    assert _build.SOURCE_FLAGS["ladder.cu"] == ("-fmad=false",)
    flags = " ".join(_build.NVCC_FLAGS) + " ".join(
        " ".join(f) for f in _build.SOURCE_FLAGS.values())
    assert "fast_math" not in flags and "fast-math" not in flags
    base = _build.library_path()
    monkeypatch.setattr(_build, "SOURCE_FLAGS", {})
    assert _build.library_path() != base
    monkeypatch.undo()
    assert _build.library_path() == base
    with open(os.path.join(_build.CSRC, "ladder.cu")) as fh:
        head = fh.read(4000)
    assert "-fmad=false" in head and "fused multiply-add" in head


# --------------------------------------------- (e): the solver on a card

def test_solver_on_a_card_launches_once_and_never_reads_pc(monkeypatch):
    """DeviceLadder with its device switched to a card (tensors stay on
    the CPU here): a dispatch is one host-to-device copy of the packed rows
    (padded to a power of two) into the card's input buffer, one launch of
    the kernel's entry over views of it that stores only the four outputs
    the solver reads and the event counts, one device-to-host copy of those
    into the pinned buffer and one sync; nothing reads pc on the host, the
    results are C-contiguous int32 host arrays of their own, and a second
    dispatch of as many rows checks and builds nothing again."""
    arr, args = _args(range(8))
    want = LK.ladder_plain(*args, DMAX=KW["DMAX"], DLOG=KW["DLOG"],
                           with_events=True)
    solver = DeviceLadder(batch=8, maxv=KW["V"], maxe=KW["E"],
                          maxh=KW["H"], maxl=KW["L"], dmax=KW["DMAX"],
                          dlog=KW["DLOG"], device="cpu")
    solver.stage_states(arr, 5)
    log, outside = [], []
    plain, read_pc, checks = LK.ladder_plain, LK._read_pc, LK.kernel_args
    D = KW["DLOG"]

    def fake_launch(c_args, dev, prof=None):
        """The kernel's results, from the plain loop (whose own reads of
        pc are its own), written where the launch's pointers say."""
        assert prof is None and dev.type == "cuda"
        (dpacked, buf, _), = [p for p in solver._plans.values()
                              if p[2] is c_args]
        rows = dpacked.shape[0]
        log.append(("launch", rows))
        ptrs = c_args[25:39]
        assert [i for i, p in enumerate(ptrs) if p is not None] \
            == [0, 1, 2, 3, 13]
        log.append("in")
        try:
            got = plain(*ladder_device.input_views(dpacked, solver.layout),
                        DMAX=KW["DMAX"], DLOG=D, with_events=True)
        finally:
            log.pop()
        for p, g in zip([ptrs[i] for i in (0, 1, 2, 3, 13)],
                        [got[i] for i in (0, 1, 2, 3, 13)]):
            n = g.numel()
            at = (p - buf.data_ptr()) // 4
            copy(buf[at:at + n], g.reshape(-1))

    def watch(pc):
        if log[-1:] != ["in"]:
            outside.append(pc)
        return read_pc(pc)

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
            return 0.25

    solver.device = torch.device("cuda")
    monkeypatch.setattr(ladder_device.lk, "launch", fake_launch)
    monkeypatch.setattr(ladder_device.lk, "kernel_args", counted_checks)
    monkeypatch.setattr(ladder_device.lk, "_read_pc", watch)
    monkeypatch.setattr(torch.Tensor, "to", to_card)
    monkeypatch.setattr(torch.Tensor, "copy_", logged_copy)
    monkeypatch.setattr(torch, "empty", empty_on_card)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Stream())
    dispatch = [("h2d", (8, solver.row_bytes), True), ("launch", 8),
                ("d2h", 8 * (2 * D + 3), True), "sync"]
    for first in (True, False):
        del log[:]
        larm, ltgt, ndec, status = solver.solve(5)
        assert log == (["checks"] if first else []) + dispatch
        assert not outside
        for g, w in zip((larm, ltgt, ndec, status), want):
            assert g.dtype == np.int32 and g.flags["C_CONTIGUOUS"]
            assert not np.shares_memory(g, solver._out.numpy())
            assert np.array_equal(g, w[:5].numpy())
    assert solver.stats["ladder_iterations"] == \
        2 * int(want[-1][:5].max()) > 0
    assert solver.stats["ladder_kernel_time"] == 2 * 0.25e-3


def test_packed_rows_are_the_staging_arrays_field_by_field():
    """The solver's one staging buffer: every field at a 16-byte aligned
    offset of a row of its own bytes, the 12 staging arrays numpy views of
    it in the C ABI's dtypes, and the kernel's 17 inputs views of the same
    bytes that equal, field by field, the arrays pack_states gives."""
    arr, args = _args(range(6))
    solver = DeviceLadder(batch=8, maxv=KW["V"], maxe=KW["E"],
                          maxh=KW["H"], maxl=KW["L"], dmax=KW["DMAX"],
                          dlog=KW["DLOG"], device="cpu")
    solver.stage_states(arr, 6)
    layout, R = ladder_device.packed_layout(KW["V"], KW["E"], KW["H"],
                                            KW["L"])
    assert R == solver.row_bytes and R % ladder_device.ALIGN == 0
    assert solver._packed.shape == (8, R)
    assert solver._packed.dtype == torch.uint8
    names = [f[0] for f in layout]
    assert names == ["esrc", "edst", "ewrt", "estr", "esin", "esout",
                     "ealive", "meta3", "nz", "hedge", "hlen", "scal"]
    end = 0
    base = solver._packed.numpy().ctypes.data
    for (name, dtype, shape, off, _), got in zip(layout, solver.row(3)):
        assert off % ladder_device.ALIGN == 0 and off >= end, name
        end = off + int(np.prod(shape)) * dtype.itemsize
        view = getattr(solver, name)
        assert view.dtype == dtype and view.shape == (8,) + shape, name
        assert view.strides[0] == R and view[0].flags["C_CONTIGUOUS"]
        assert view.ctypes.data == base + off, name
        assert got.ctypes.data == base + 3 * R + off, name
    assert end <= R
    views = ladder_device.input_views(solver._packed[:6], layout)
    want = LK.batch_from_numpy(arr, "cpu")
    assert len(views) == len(LK.ARG_NAMES)
    for name, v, w in zip(LK.ARG_NAMES, views, want):
        assert v.dtype == w.dtype and v.shape == w.shape, name
        assert torch.equal(v, w), name
        assert v.untyped_storage().data_ptr() == \
            solver._packed.untyped_storage().data_ptr(), name
    # the kernel takes these views as they are, a graph a row apart
    _, c_args = LK.kernel_args(views, KW["DMAX"], KW["DLOG"])
    strides = list(c_args[-1])
    for name, v, st in zip(LK.ARG_NAMES, views, strides):
        assert st * v.element_size() == R, name


# ------------------------------- the kernel's machine, built for the host

def build_host_library(directory):
    """csrc/ladder_host.cpp built with g++ (C++20 for std::barrier and
    std::atomic_ref; no fused multiply-add) into `directory`; the ctypes
    library with its entries declared.  Skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel's machine for the host")
    lib = str(directory / "libladder_host.so")
    subprocess.run([cxx, "-std=c++20", "-O2", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-o", lib,
                    os.path.join(_build.CSRC, "ladder_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(lib)
    dll.aletsch_ladder_host.argtypes = _build.LADDER_ARGTYPES + [ctypes.c_int]
    dll.aletsch_ladder_host.restype = ctypes.c_int
    return dll


@pytest.fixture(scope="module")
def host_machine(tmp_path_factory):
    """csrc/ladder_host.cpp built with g++; its entry takes ladder_cuda's
    arguments and the threads of its block (one by default)."""
    fn = build_host_library(tmp_path_factory.mktemp("ladder_host")) \
        .aletsch_ladder_host

    def run(args, DMAX, DLOG, maxiter=None, nt=1):
        outs, c_args = LK.kernel_args(args, DMAX, DLOG, maxiter)
        assert fn(*c_args, nt) == 0
        return outs
    return run


# (seeds, shape, maxiter, whether some graph must overflow): the shape of
# the CPU tests, the iteration cap, and shapes that force each capacity
# check: the log (DLOG), the adjacency lists (DMAX, whose ranks then
# collide in the last slot), the edge slots (E, with small hyper lists)
MACHINE_CASES = [
    (range(0, 60), KW, None, False), (range(60, 120), KW, None, False),
    (range(0, 40), KW, 17, True),
    (range(0, 60), dict(KW, DLOG=4), None, True),
    (range(0, 60), dict(KW, DMAX=2), None, True),
    (range(0, 60), dict(KW, DMAX=3, DLOG=9), None, True),
    (range(0, 150), dict(KW, E=40), None, True),
    (range(0, 150), dict(KW, E=30, H=8, L=8), None, True)]


@pytest.mark.parametrize("seeds, kw, maxiter, overflows", MACHINE_CASES)
def test_host_built_machine_equals_the_plain_loop(host_machine, seeds, kw,
                                                  maxiter, overflows):
    shape = {k: kw[k] for k in "VEHL"}
    _, args = _args(seeds, shape)
    want = LK.ladder_plain(*args, DMAX=kw["DMAX"], DLOG=kw["DLOG"],
                           maxiter=maxiter, with_events=True)
    got = host_machine(args, kw["DMAX"], kw["DLOG"], maxiter)
    _assert_same(str(kw), got, want)
    status = want[3].numpy()
    assert (status == LK.ST_CLEAN).any()
    assert (status == LK.ST_OVERFLOW).any() == overflows, kw


def test_host_built_machine_on_the_fixtures_and_the_production_shape(
        host_machine):
    """The ladder fixtures at their tests' shape (as fixture_states builds
    them for chip_smoke.py and tests/test_torch_ladder.py) and fuzz states
    at the production shape (V 64, E 256, H 64, L 32, DMAX 32, DLOG
    192)."""
    shape = {k: FIX_KW[k] for k in "VEHL"}
    states = LK.fixture_states(LADDER, **shape)[::3]
    assert len(states) > 30
    arr = LK.pack_states(states, len(states), **shape)
    args = LK.batch_from_numpy(arr, "cpu")
    want = LK.ladder_plain(*args, DMAX=FIX_KW["DMAX"], DLOG=FIX_KW["DLOG"],
                           with_events=True)
    _assert_same("fixtures", host_machine(args, FIX_KW["DMAX"],
                                          FIX_KW["DLOG"]), want)
    full = dict(V=LK.DEFAULT_V, E=LK.DEFAULT_E, H=LK.DEFAULT_H,
                L=LK.DEFAULT_L)
    _, args = _args(range(12), full)
    want = LK.ladder_plain(*args, with_events=True)
    _assert_same("production shape", host_machine(
        args, LK.DEFAULT_DMAX, LK.DEFAULT_DLOG), want)


def _zero_weights(arr, how):
    """A copy of packed states with zero weights.  "live": one live edge
    of every even row weighs +0.0, which the exports accept.  "signed":
    -0.0 in every empty slot and on each vertex's first in- and out-edge
    (the slots the plain body adds +0.0 to on steps where nothing
    triggers), and on slot 0 (where an empty list's index clamps)."""
    out = {k: v.copy() for k, v in arr.items()}
    ew = out["ewrt"]
    rng = np.random.default_rng(0)
    for b in range(len(ew)):
        ne = int(out["nedges"][b])
        if how == "live":
            if b % 2 == 0:
                ew[b, rng.integers(0, ne)] = 0.0
            continue
        ew[b, ne:] = -0.0
        ew[b, 0] = -0.0
        for ends, stamps in (("edst", "esin"), ("esrc", "esout")):
            first = {}
            for j in range(ne):
                v = int(out[ends][b, j])
                if v not in first or out[stamps][b, j] < \
                        out[stamps][b, first[v]]:
                    first[v] = j
            ew[b, list(first.values())] = -0.0
    return out


def test_plain_sqrt_is_correctly_rounded():
    """The plain form's f64 sqrt on the CPU is IEEE's (torch's own CPU
    kernel misses by an ulp on some inputs, sqrt(0.5) among them)."""
    x = np.concatenate([[0.5, 0.0, 2.0, 1e-300, 1e17],
                        np.random.default_rng(3).random(20000) * 100])
    got = LK.ieee_sqrt(torch.from_numpy(x)).numpy()
    want = np.array([math.sqrt(v) for v in x])
    assert np.array_equal(_bits(got), _bits(want))


def test_zero_weight_edges_equal_the_jax_program_and_the_machine(
        host_machine):
    """Live edges of weight 0 (balancing a root whose sums are 50 and
    0.01 takes sqrt(0.5) on one of these rows): the plain form == the
    JAX package's program == the kernel's machine, every output bit for
    bit."""
    arr = _zero_weights(_args(range(60))[0], "live")
    args = LK.batch_from_numpy(arr, "cpu")
    want = LK.ladder_plain(*args, DMAX=KW["DMAX"], DLOG=KW["DLOG"],
                           with_events=True)
    _assert_same("machine", host_machine(args, KW["DMAX"], KW["DLOG"]),
                 want)
    jax_out = _jax(arr, KW, 4 * KW["V"] ** 2)
    _assert_same("jax", [t.numpy() for t in want], jax_out)


def test_signed_zero_weights_change_only_the_sign_of_a_zero(host_machine):
    """The one known departure of the kernel's per-graph run from the
    plain lockstep loop: the plain body adds +0.0 to the root's first in-
    and out-edge weights on steps where nothing triggers, so a -0.0 there
    comes out +0.0.  On states full of -0.0 weights the two agree in
    every output but ewrt, in ewrt up to the sign of a zero, and the four
    outputs DeviceLadder ships (larm, ltgt, ndec, status) are those of
    the same states with +0.0."""
    arr = _zero_weights(_args(range(60))[0], "signed")
    args = LK.batch_from_numpy(arr, "cpu")
    kw = dict(DMAX=KW["DMAX"], DLOG=KW["DLOG"])
    want = LK.ladder_plain(*args, with_events=True, **kw)
    got = host_machine(args, KW["DMAX"], KW["DLOG"])
    ew = NAMES.index("ewrt")
    _assert_same("signed zeros", got[:ew] + got[ew + 1:],
                 want[:ew] + want[ew + 1:])
    g, w = got[ew].numpy(), want[ew].numpy()
    apart = _bits(g) != _bits(w)
    assert apart.any() and (g[apart] == 0).all() and (w[apart] == 0).all()
    pos = dict(arr, ewrt=arr["ewrt"] + 0.0)
    assert not np.signbit(pos["ewrt"]).any()
    plus = LK.ladder_plain(*LK.batch_from_numpy(pos, "cpu"), **kw)
    _assert_same("shipped", got[:4], plus[:4])


@pytest.mark.parametrize("source", ["fuzz", "production-shape fuzz",
                                    "fixtures"])
def test_exports_carry_no_signed_zero_weight(source):
    """The states the ladder is held on carry no -0.0 (nor negative)
    weight, so there the kernel and the plain form agree in ewrt too
    (tests/test_torch_e2e.py checks the native export's staged rows)."""
    full = dict(V=LK.DEFAULT_V, E=LK.DEFAULT_E, H=LK.DEFAULT_H,
                L=LK.DEFAULT_L)
    if source == "fixtures":
        shape = {k: FIX_KW[k] for k in "VEHL"}
        states = LK.fixture_states(LADDER, **shape)
        arr = LK.pack_states(states, len(states), **shape)
    else:
        arr = _args(range(120), SHAPE if source == "fuzz" else full)[0]
    assert len(arr["nv"]) > 50
    assert not np.signbit(arr["ewrt"]).any()


# ----------------------------------------------------------- on the card

@pytest.mark.cuda
def test_ladder_kernel_matches_plain_on_card():
    """ladder_cuda against ladder_plain on the host CPU: every output and
    the event counts, ewrt on int64 views, one launch (needs a GPU and
    nvcc; python3 chip_smoke.py runs the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    arr, args = _args(range(40))
    kw = dict(DMAX=KW["DMAX"], DLOG=KW["DLOG"])
    want = LK.ladder_plain(*args, with_events=True, **kw)
    n0 = LK.ladder_cuda.launches
    got = LK.ladder(*LK.batch_from_numpy(arr, "cuda"), with_events=True,
                    **kw)
    torch.cuda.synchronize()
    assert LK.ladder_cuda.launches == n0 + 1
    _assert_same("card", [t.cpu() for t in got], want)


@pytest.mark.cuda
def test_ladder_solver_over_a_mesh_of_cards(monkeypatch):
    """DeviceLadder.solve on the card with the mesh emulated as two and as
    three cuda:0 devices (ops/meshing.py's split and replicated branches)
    at 1, 3, 37 and 64 rows of production-shape states == one device, bit
    for bit: one kernel launch a shard, the mesh's bytes in and out
    accounted (needs a GPU and nvcc; chip_smoke.py's phase 2c runs the
    same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from aletsch_tpu_torch.ops import meshing
    shape = dict(V=LK.DEFAULT_V, E=LK.DEFAULT_E, H=LK.DEFAULT_H,
                 L=LK.DEFAULT_L)
    _, states = LK.fuzz_states(range(100), **shape)
    assert len(states) >= 64      # some seeds give no state
    arr = LK.pack_states(states[:64], 64, **shape)

    def staged():
        solver = DeviceLadder(device="cuda")
        solver.stage_states(arr, 64)
        return solver
    one = staged()
    want = {rows: one.solve(rows) for rows in (1, 3, 37, 64)}
    for n in (2, 3):
        monkeypatch.setattr(meshing, "_local_devices",
                            lambda d, n=n: [torch.device("cuda", 0)] * n)
        solver = staged()
        for rows, w in want.items():
            n0 = LK.ladder_cuda.launches
            got = solver.solve(rows)
            assert LK.ladder_cuda.launches == n0 + n, (n, rows)
            _assert_same("%d devices, %d rows" % (n, rows), got, w)
        st = solver.stats
        assert st["mesh_devices"] == n and st["mesh_dispatches"] == 4
        # the dispatch ships its rows padded to a power of two
        shipped = sum(ladder_device.bucket(r, solver.batch) for r in want)
        assert st["mesh_bytes_in"] == shipped * solver.row_bytes
        assert st["mesh_bytes_out"] == sum(
            a.nbytes for w in want.values() for a in w)
