"""The ladder kernel's machine on a block of host threads.

csrc/ladder_host.cpp builds the per-graph machine (csrc/ladder_machine.cuh)
with the host form of its block primitives (csrc/ladder_block.cuh): nt
std::threads under a std::barrier, with std::atomic_ref for the atomics.
These tests hold, at several thread counts, the machine to the plain form
(every output and the event counts, bit for bit), each block primitive to
its serial form, and the hyper lists' occurrence index and the queries
through it to a brute-force scan; and they run the machine under
ThreadSanitizer, which reports any two threads touching the same shared
word between two barriers, one of them writing, without an atomic."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aletsch_tpu_torch.ops import ladder_kernel as LK
from test_torch_ladder import FIX_KW, KW, LADDER, SHAPE
from test_torch_ladder_kernel import _assert_same, build_host_library

FULL = dict(V=LK.DEFAULT_V, E=LK.DEFAULT_E, H=LK.DEFAULT_H, L=LK.DEFAULT_L,
            DMAX=LK.DEFAULT_DMAX, DLOG=LK.DEFAULT_DLOG)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    lib = build_host_library(tmp_path_factory.mktemp("ladder_threads"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.aletsch_ladder_block_host.argtypes = [i, i, p, i, p]
    lib.aletsch_ladder_block_host.restype = i
    lib.aletsch_ladder_occ_host.argtypes = [i] * 8 + [p] * 7
    lib.aletsch_ladder_occ_host.restype = i
    return lib


# ------------------------------------------- the machine at nt threads

def _batch(source):
    """(packed arrays, DMAX, DLOG) of a batch: 20 fuzz states at the CPU
    tests' shape or at the production shape, or 16 ladder fixtures."""
    if source == "fixtures":
        shape = {k: FIX_KW[k] for k in "VEHL"}
        states = LK.fixture_states(LADDER, **shape)[::5][:16]
        return LK.pack_states(states, len(states), **shape), FIX_KW
    kw = KW if source == "fuzz" else FULL
    shape = {k: kw[k] for k in "VEHL"}
    _, states = LK.fuzz_states(range(100, 120), **shape)
    return LK.pack_states(states, len(states), **shape), kw


@pytest.fixture(scope="module")
def batches():
    """Each source's arrays and the plain form's outputs, made once."""
    out = {}
    for source in ("fuzz", "production-shape fuzz", "fixtures"):
        arr, kw = _batch(source)
        args = LK.batch_from_numpy(arr, "cpu")
        out[source] = (args, kw, LK.ladder_plain(
            *args, DMAX=kw["DMAX"], DLOG=kw["DLOG"], with_events=True))
    return out


@pytest.mark.parametrize("nt", [1, 8, 32])
@pytest.mark.parametrize("source", ["fuzz", "production-shape fuzz",
                                    "fixtures"])
def test_threaded_machine_equals_the_plain_form(dll, batches, source, nt):
    args, kw, want = batches[source]
    assert len(args[0]) >= 16
    outs, c_args = LK.kernel_args(args, kw["DMAX"], kw["DLOG"])
    assert dll.aletsch_ladder_host(*c_args, nt) == 0
    _assert_same("%s, %d threads" % (source, nt), outs, want)


@pytest.mark.parametrize("nt", [3, 32])
def test_threaded_machine_at_every_overflow(dll, nt):
    """The shapes that force each capacity check (the log, the lists whose
    ranks collide in the last slot, the edge slots) and the iteration cap,
    on an odd thread count and on 32."""
    for kw, seeds, maxiter in ((dict(KW, DLOG=4), range(0, 30), None),
                               (dict(KW, DMAX=2), range(0, 30), None),
                               (dict(KW, E=40), range(110, 130), None),
                               (KW, range(0, 20), 17)):
        shape = {k: kw[k] for k in "VEHL"}
        _, states = LK.fuzz_states(seeds, **shape)
        args = LK.batch_from_numpy(
            LK.pack_states(states, len(states), **shape), "cpu")
        want = LK.ladder_plain(*args, DMAX=kw["DMAX"], DLOG=kw["DLOG"],
                               maxiter=maxiter, with_events=True)
        assert (want[3].numpy() == LK.ST_OVERFLOW).any(), kw
        outs, c_args = LK.kernel_args(args, kw["DMAX"], kw["DLOG"], maxiter)
        assert dll.aletsch_ladder_host(*c_args, nt) == 0
        _assert_same("%s, %d threads" % (kw, nt), outs, want)


# ------------------------------------------------- the block primitives

def _prim(dll, kind, nt, values):
    x = np.ascontiguousarray(values, dtype=np.int32)
    out = np.full(max(nt, len(x) + 1), -7, np.int32)
    assert dll.aletsch_ladder_block_host(kind, nt, x.ctypes.data, len(x),
                                         out.ctypes.data) == 0
    return out


SERIAL = {
    "min": (0, lambda x: int(x.min()) if len(x) else LK.BIGI),
    "or": (1, lambda x: int(bool((x != 0).any()))),
    "and": (2, lambda x: int(bool((x != 0).all()))),
    "first": (3, lambda x: int(np.flatnonzero(x)[0]) if x.any() else len(x)),
}


@pytest.mark.parametrize("name", sorted(SERIAL))
def test_block_reductions_equal_their_serial_form(dll, name):
    """Every thread of the block gets the serial result, whatever the split
    of the items over the threads (fewer items than threads, more, none)."""
    kind, serial = SERIAL[name]
    rng = np.random.default_rng(kind)
    for nt in (1, 3, 8, 32):
        for n in (0, 1, 5, nt, 2 * nt + 3, 64, 257):
            if name in ("or", "and", "first"):
                x = (rng.random(n) < rng.choice([0.02, 0.5, 0.98])) \
                    .astype(np.int32)
            else:
                x = rng.integers(-1000, 1000, n)
            got = _prim(dll, kind, nt, x)[:nt]
            assert (got == serial(x)).all(), (name, nt, n)


def test_block_scan_equals_the_serial_prefix_sum(dll):
    rng = np.random.default_rng(9)
    for nt in (1, 3, 8, 32):
        for n in (0, 1, 7, nt, 2 * nt + 1, 128, 257):
            x = rng.integers(0, 9, n)
            got = _prim(dll, 4, nt, x)[:n + 1]
            want = np.concatenate([[0], np.cumsum(x)])
            assert np.array_equal(got, want), (nt, n)


# ------------------------------------------------ the occurrence index

def _remove_mask(hedge, hlen, emask, E):
    for h in range(len(hlen)):
        for p in range(min(hedge.shape[1], hlen[h])):
            x = hedge[h, p]
            if x >= 0 and emask[min(x, E - 1)]:
                hedge[h, p] = -1


def _replace_single(hedge, hlen, x, e):
    for h in range(len(hlen)):
        for p in range(min(hedge.shape[1], hlen[h])):
            if hedge[h, p] == x:
                hedge[h, p] = e


def _replace_pair(hedge, hlen, x, y, e):
    L = hedge.shape[1]
    for h in range(len(hlen)):
        n, row = hlen[h], hedge[h].tolist()
        out, prev = [], False
        for p in range(L):
            valid = p < n
            match = valid and p + 1 < L and p + 1 < n and row[p] == x \
                and row[p + 1] == y
            if valid and not prev:
                out.append(e if match else row[p])
            prev = match
        hedge[h] = out + [-1] * (L - len(out))
        hlen[h] = len(out)


def _valid(hedge, hlen, h):
    return hedge[h, :min(max(int(hlen[h]), 0), hedge.shape[1])].tolist()


def _hat(row, l, right):
    return row[len(row) - 1 - l] if right else row[l]


def _dominates(hedge, hlen, ec, right):
    """The plain scan over every entry of every row (the kernel's first
    form), for one edge."""
    rows = [_valid(hedge, hlen, h) for h in range(len(hlen))]

    def has_x2(n1, n2):
        for row in rows:
            for l in range(1, len(row) - 1):
                if _hat(row, l, right) != ec or _hat(row, l - 1, right) == -1:
                    continue
                if _hat(row, l + 1, right) != n1:
                    continue
                n2x = _hat(row, l + 2, right) if l + 2 < len(row) else -1
                if n2 == -1 or n2x == n2:
                    return True
        return False
    for row in rows:
        for l in range(len(row) - 1):
            if _hat(row, l, right) != ec:
                continue
            n1 = _hat(row, l + 1, right)
            if n1 == -1 or (l > 0 and _hat(row, l - 1, right) != -1):
                continue
            n2 = _hat(row, l + 2, right) if l + 2 < len(row) else -1
            if not has_x2(n1, n2):
                return False
    return True


def _extends(hedge, hlen, ec):
    le = re = False
    for h in range(len(hlen)):
        row = _valid(hedge, hlen, h)
        for p, x in enumerate(row):
            if x == ec:
                le = le or (p > 0 and row[p - 1] != -1)
                re = re or (p + 1 < len(row) and row[p + 1] != -1)
    return le, re


@pytest.mark.parametrize("nt", [1, 8])
def test_occurrence_index_equals_a_brute_force_scan(dll, nt):
    """Random replace_pair / replace_single / remove_mask sequences on hyper
    lists dense in repeats of a few edges (rows longer, shorter and as
    long as their capacity, entries past the edges): after each update the
    rows equal a transcription of the plain form's updates, the index holds
    exactly each edge's (row, position) entries of the valid prefixes, and
    dominates (both directions) and extends through the index equal the
    scan over every entry."""
    rng = np.random.default_rng(nt)
    H, L, E = 12, 10, 9
    checked = 0
    for trial in range(6):
        hedge = rng.integers(-1, E, (H, L)).astype(np.int32)
        hedge[rng.random((H, L)) < 0.05] = E + 2    # no edge of the graph
        hlen = rng.integers(-1, L + 3, H).astype(np.int32)
        for step in range(12):
            op = int(rng.integers(0, 3))
            x, y, e = (int(v) for v in rng.integers(0, E, 3))
            emask = (rng.random(E) < 0.3).astype(np.uint8)
            want_h, want_l = hedge.copy(), hlen.copy()
            if op == 0:
                _replace_pair(want_h, want_l, x, y, e)
            elif op == 1:
                _replace_single(want_h, want_l, x, e)
            else:
                _remove_mask(want_h, want_l, emask, E)
            ofs = np.zeros(E + 1, np.int32)
            occ = np.zeros(H * L, np.int32)
            dom = np.zeros(2 * E, np.uint8)
            ext = np.zeros(2 * E, np.uint8)
            assert dll.aletsch_ladder_occ_host(
                nt, H, L, E, op, x, y, e, emask.ctypes.data,
                hedge.ctypes.data, hlen.ctypes.data, ofs.ctypes.data,
                occ.ctypes.data, dom.ctypes.data, ext.ctypes.data) == 0
            assert np.array_equal(hedge, want_h) and \
                np.array_equal(hlen, want_l), (trial, step, op)
            assert ofs[0] == 0 and (np.diff(ofs) >= 0).all()
            for ec in range(E):
                got = sorted(occ[ofs[ec]:ofs[ec + 1]].tolist())
                want = [h * L + p for h in range(H)
                        for p, v in enumerate(_valid(hedge, hlen, h))
                        if v == ec]
                assert got == want, (trial, step, ec)
                for right in (False, True):
                    assert dom[2 * ec + right] == _dominates(
                        hedge, hlen, ec, right), (trial, step, ec, right)
                assert tuple(ext[2 * ec:2 * ec + 2]) == _extends(
                    hedge, hlen, ec), (trial, step, ec)
                checked += dom[2 * ec] + dom[2 * ec + 1] < 2
    assert checked > 50       # the dominate queries do say no


# ------------------------------------------------- ThreadSanitizer

TSAN_RUN = r"""
import ctypes, sys
import torch
torch.set_num_threads(1)
from aletsch_tpu_torch.ops import ladder_kernel as LK, _build
from test_torch_ladder_kernel import _args, _assert_same
from test_torch_ladder import KW
fn = ctypes.CDLL(sys.argv[1]).aletsch_ladder_host
fn.argtypes = _build.LADDER_ARGTYPES + [ctypes.c_int]
fn.restype = ctypes.c_int
for seeds, nt in ((range(0, 6), 8), (range(6, 10), 5)):
    _, args = _args(seeds)
    want = LK.ladder_plain(*args, DMAX=KW["DMAX"], DLOG=KW["DLOG"],
                           with_events=True)
    outs, c_args = LK.kernel_args(args, KW["DMAX"], KW["DLOG"])
    assert fn(*c_args, nt) == 0
    _assert_same("tsan", outs, want)
print("machine ran")
"""


def test_threaded_machine_has_no_data_race(tmp_path):
    """The machine built with -fsanitize=thread and run on 8 and 5 threads:
    ThreadSanitizer reports nothing, and the outputs still equal the plain
    form's.  (It does report a barrier taken out of build_lists.)"""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    tsan = subprocess.run([cxx, "-print-file-name=libtsan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(tsan) or not os.path.exists(tsan):
        pytest.skip("needs g++'s ThreadSanitizer runtime (libtsan)")
    lib = str(tmp_path / "libladder_tsan.so")
    src = os.path.join(os.path.dirname(LK.__file__), "..", "csrc",
                       "ladder_host.cpp")
    subprocess.run([cxx, "-std=c++20", "-O1", "-g", "-ffp-contract=off",
                    "-pthread", "-fsanitize=thread", "-shared", "-fPIC",
                    "-o", lib, src], check=True, capture_output=True,
                   timeout=300)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LD_PRELOAD=os.path.realpath(tsan),
               TSAN_OPTIONS="halt_on_error=0 report_signal_unsafe=0",
               PYTHONPATH=os.pathsep.join(
                   [here, os.path.dirname(here),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", TSAN_RUN, lib], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "machine ran" in res.stdout, res.stderr[-3000:]
    assert "ThreadSanitizer" not in res.stderr, res.stderr[-3000:]
