"""The bridge kernel's machine on a team of host threads.

csrc/bridge_host.cpp builds the per-instance machine
(csrc/bridge_machine.cuh) with the host form of the warp's primitives
(csrc/team.cuh): nt std::threads stand in for the lanes, a std::barrier
and a slot a thread for the warp's vote, reduction and shuffle.  These
tests hold, at several lane counts (1, 3, 5 and the card's 32), the machine
to the plain form, the JAX package's program and the numpy oracle (every
output, bit for bit), each primitive to its serial form, and run the
machine under ThreadSanitizer, which reports any two threads touching the
same shared word between two barriers, one of them writing."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aletsch_tpu_torch.ops import bridge_topk as BT
from test_torch_bridge_kernel import (SMALL, _assert_same, _closed_form_batch,
                                      _edge_batch, _fuzz, _jax, _plain,
                                      build_host_library,
                                      compile_host_library, host_runner)

FUZZ = ["random, small shape", "tie-heavy, small shape",
        "random, production shape", "tie-heavy, production shape"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dll(tmp_path_factory):
    return build_host_library(tmp_path_factory.mktemp("bridge_threads"))


# ------------------------------------------- the machine at nt lanes

@pytest.mark.parametrize("nt", [3, 5, 32])
@pytest.mark.parametrize("kind", FUZZ)
def test_machine_on_lanes_equals_plain_jax_and_oracle(dll, kind, nt):
    """The four fuzz batches (64 rows; their plain form, JAX program and
    numpy oracle agree, test_torch_bridge_kernel.py::_fuzz) through the
    machine on nt lanes, and the first 3 rows alone."""
    batch, want = _fuzz(kind)
    run = host_runner(dll)
    _assert_same("%s, %d lanes" % (kind, nt), run(batch, nt), want)
    _assert_same("%s, %d lanes, 3 rows" % (kind, nt),
                 run([a[:3] for a in batch], nt), [w[:3] for w in want])


@pytest.mark.parametrize("nt", [1, 3, 32])
def test_machine_on_lanes_at_the_edge_cases_and_the_int32_wrap(dll, nt):
    """The hand-made edge batch (K candidates tied on every key, weights
    0 and 999999, absent targets, an empty window), the closed-form batch
    and the int32 wrap of lengths and keys, where valid key tuples pass
    the absent candidates' (BIG, ..., BIG) and some tie it: the machine on
    nt lanes == the plain form == the JAX program (and the oracle, where
    nothing wraps)."""
    run = host_runner(dll)
    for tag, batch in (("edge", _edge_batch()),
                       ("closed form", _closed_form_batch())):
        want = _plain(batch)
        _assert_same(tag + ": oracle", BT.bridge_dp_host(*batch), want)
        _assert_same(tag + ": machine", run(batch, nt), want)
    _assert_same("edge: JAX", _jax(_edge_batch()), _plain(_edge_batch()))
    rng = np.random.default_rng(8)
    P, Wt, Lv, tgt = BT.fuzz_batch(rng, 16, *SMALL)
    Lv[:8] = rng.integers(2**30, 2**31 - 1, size=Lv[:8].shape)
    live = P[8:] >= 0
    Wt[8:] = np.where(live, rng.choice(
        np.array([-2**31, -2**30 - 1, -2**30, -5, 0, 7], np.int32),
        size=Wt[8:].shape), 0)
    batch = (P, Wt, Lv, tgt)
    want = _plain(batch)
    _assert_same("wrap: JAX", _jax(batch), want)
    _assert_same("wrap: machine", run(batch, nt), want)
    # weights whose key ties an absent candidate's (-(-2^30) == BIG),
    # passes it (-(-2^30 - 1) == BIG + 1) or wraps (-(-2^31) == -2^31)
    assert (Wt[8:][live] == -2**30).any() and (Wt[8:][live] < -2**30).any()


@pytest.mark.parametrize("nt", [1, 5, 32])
def test_machine_reads_rows_at_any_stride(dll, nt):
    """Inputs whose instance rows lie one int further apart than their data
    (so most rows are not 16-byte aligned, and their copies go an int a
    lane) and a batch with more in-edge slots than the lanes (the slot's
    predecessor read from shared memory, not shuffled): the machine ==
    the plain form."""
    batch, want = _fuzz("tie-heavy, small shape")
    args = []
    for a in BT.batch_from_numpy(*batch, "cpu"):
        wide = torch.zeros((a.shape[0], a[0].numel() + 1), dtype=a.dtype)
        wide[:, :-1] = a.reshape(a.shape[0], -1)
        args.append(wide[:, :-1].view(a.shape) if a.dim() == 2
                    else wide[:, :-1].unflatten(1, a.shape[1:]))
    outs, c_args = BT.kernel_args(*args)
    assert c_args[8] == batch[0][0].size + 1
    assert dll.aletsch_bridge_host(*c_args, None, nt) == 0
    _assert_same("odd strides, %d lanes" % nt, [t.numpy() for t in outs],
                 want)
    wide_e = BT.fuzz_batch(np.random.default_rng(40), 12, 16, 40, 4)
    _assert_same("40 in-edge slots, %d lanes" % nt,
                 host_runner(dll)(wide_e, nt), _plain(wide_e))


def test_step_counts_do_not_depend_on_the_lanes(dll):
    """The machine's counts (steps run, empty, past the end, valid
    candidates) on the production-shape random batch are the same at 1, 5
    and 32 lanes, and add up: every instance's V - 1 steps are run or past
    its end."""
    batch, want = _fuzz("random, production shape")
    run = host_runner(dll)
    counts = [run(batch, nt, counts=True) for nt in (1, 5, 32)]
    for got, c in counts:
        _assert_same("counts run", got, want)
        assert c == counts[0][1]
    c = counts[0][1]
    n, V = batch[0].shape[:2]
    assert c["steps"] + c["tail_steps"] == n * (V - 1)
    assert 0 < c["empty_steps"] < c["steps"] and c["tail_steps"] > 0
    # a valid candidate is an entry of a live predecessor (the oracle's
    # entry counts: pix >= 0, one at the source)
    P = batch[0]
    entries = (want[2] >= 0).sum(axis=2)
    entries[:, 0] = 1
    live = (P >= 0) & (P < V)
    m = (entries[np.arange(n)[:, None, None], np.clip(P, 0, V - 1)] * live)
    assert c["candidates"] == int(m[:, 1:].sum())


# ---------------------------------------------------- the primitives

def _lanes(dll, kind, nt, values):
    x = np.ascontiguousarray(values, dtype=np.int32)
    out = np.full(nt, -7, np.int32)
    assert dll.aletsch_bridge_lanes_host(kind, nt, x.ctypes.data,
                                         out.ctypes.data) == 0
    return out


@pytest.mark.parametrize("nt", [1, 3, 5, 32])
def test_lex_argmin_equals_its_serial_form(dll, nt):
    """team::lex_argmin on nt lanes: every lane gets the lane whose (six
    keys, position) tuple comes first among the lanes that have one (-1
    where none has), whatever the ties: keys drawn from a few values,
    int32's ends among them, positions distinct."""
    rng = np.random.default_rng(nt)
    ends = np.array([-2**31, -1, 0, 1, 2**30, 2**31 - 1], np.int64)
    for trial in range(300):
        has = rng.random(nt) < rng.choice([0.0, 0.2, 0.7, 1.0])
        keys = rng.choice(ends[:int(rng.integers(1, 7))], size=(nt, 6))
        pos = rng.permutation(4 * nt)[:nt]
        rows = np.concatenate([has[:, None], keys, pos[:, None]], axis=1)
        got = _lanes(dll, 0, nt, rows.reshape(-1))
        cand = [tuple(rows[t, 1:]) + (t,) for t in range(nt) if has[t]]
        want = min(cand)[-1] if cand else -1
        assert (got == want).all(), (trial, rows.tolist(), got)


@pytest.mark.parametrize("nt", [1, 3, 5, 32])
def test_lane_primitives_equal_their_serial_forms(dll, nt):
    """ballot, lanes_min, lanes_max and bcast on nt lanes: every lane gets
    the serial result."""
    rng = np.random.default_rng(100 + nt)
    for trial in range(50):
        x = rng.integers(-2**31, 2**31, nt)
        flags = (rng.random(nt) < rng.choice([0.0, 0.5, 1.0])).astype(int)
        want = sum(1 << t for t in range(nt) if flags[t])
        assert (_lanes(dll, 1, nt, flags).view(np.uint32) == want).all()
        assert (_lanes(dll, 2, nt, x) == x.min()).all()
        assert (_lanes(dll, 3, nt, x) == x.max()).all()
        src = int(rng.integers(0, nt))
        assert (_lanes(dll, 4, nt, np.append(x, src)) == x[src]).all()


# ------------------------------------------------- ThreadSanitizer

TSAN_RUN = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from aletsch_tpu_torch.ops import bridge_topk as BT
from test_torch_bridge_kernel import FULL, SMALL, _plain, _assert_same
from test_torch_bridge_kernel import _closed_form_batch, _edge_batch
from test_torch_bridge_kernel import host_runner
from test_torch_bridge_kernel import declare
import ctypes
run = host_runner(declare(ctypes.CDLL(sys.argv[1])))
for batch, nt in ((BT.fuzz_batch(np.random.default_rng(5), 6, *SMALL,
                                 ties=True), 8),
                  (BT.fuzz_batch(np.random.default_rng(6), 2, *FULL), 5),
                  (_edge_batch(), 3), (_closed_form_batch(), 5)):
    _assert_same("tsan", run(batch, nt), _plain(batch))
print("machine ran")
"""


def test_machine_on_lanes_has_no_data_race(tmp_path):
    """The machine built with -fsanitize=thread and run on 8, 5 and 3
    lanes: ThreadSanitizer reports nothing, and the outputs still equal
    the plain form's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++")
    tsan = subprocess.run([cxx, "-print-file-name=libtsan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(tsan) or not os.path.exists(tsan):
        pytest.skip("needs g++'s ThreadSanitizer runtime (libtsan)")
    lib = compile_host_library(tmp_path, ("-O1", "-g", "-fsanitize=thread"))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LD_PRELOAD=os.path.realpath(tsan),
               TSAN_OPTIONS="halt_on_error=0 report_signal_unsafe=0",
               PYTHONPATH=os.pathsep.join(
                   [here, os.path.dirname(here),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", TSAN_RUN, lib],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert "machine ran" in res.stdout, res.stderr[-3000:]
    assert "ThreadSanitizer" not in res.stderr, res.stderr[-3000:]
