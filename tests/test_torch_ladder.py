"""The port's resolution ladder (aletsch_tpu_torch/ops/ladder_kernel.py,
ladder_device.py) against the port's dense reference machine
(ops/ladder_ref.py), the host Scallop's own arms, and the JAX package's
kernel (aletsch_tpu/ops/ladder_kernel.py, the jitted XLA program on the
IEEE-f64 CPU backend), on the same seeded states.  Tolerance zero:
decision logs, statuses and integer fields with ==, f64 weights on int64
views.  Ports of tests/test_ladder_kernel.py and
tests/test_ladder_fixture_device.py."""

import os
import random

import numpy as np
import pytest
import torch

from aletsch_tpu.ops import ladder_kernel as ref_kernel
from aletsch_tpu_torch.config import Parameters
from aletsch_tpu_torch.core.graph_io import simulate_graph
from aletsch_tpu_torch.ops import ladder_kernel, ladder_ref
from aletsch_tpu_torch.ops.ladder_device import DeviceLadder
from aletsch_tpu_torch.scallop.decompose import Scallop
from test_graph_reference import _load_phases, _stamp
from test_ladder_kernel import make_broken as ref_make_broken
from test_ladder_kernel import make_states as ref_make_states
from test_ladder_ref import LoggingScallop, run_restricted

# small shapes keep the CPU fuzz fast (those of tests/test_ladder_kernel.py)
KW = dict(V=24, E=96, H=16, L=16, DMAX=12, DLOG=64)
SHAPE = {k: KW[k] for k in "VEHL"}
FIX_KW = dict(V=48, E=192, H=24, L=24, DMAX=24, DLOG=96)
LADDER = os.path.join(os.path.dirname(__file__), "fixtures", "ladder")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_final_state(b, ref, finals):
    """The kernel's final dense fields of row b == the reference machine's
    state after run_ladder, index for index and bit for bit."""
    ewrt, ealive, esrc, edst, estr, nedges, hedge, hlen, nz = finals
    ne = ref.n_edges
    assert int(nedges[b]) == ne
    assert np.array_equal(ealive[b, :ne], ref.e_alive[:ne]), b
    am = ref.e_alive[:ne]
    assert np.array_equal(esrc[b, :ne][am], ref.e_src[:ne][am]), b
    assert np.array_equal(edst[b, :ne][am], ref.e_dst[:ne][am]), b
    assert np.array_equal(_bits(ewrt[b, :ne][am]),
                          _bits(ref.e_wrt[:ne][am])), b
    assert np.array_equal(estr[b, :ne][am],
                          ref.e_str[:ne][am].astype(np.int32)), b
    nh = ref.n_hyper
    assert np.array_equal(hlen[b, :nh], ref.h_len[:nh]), b
    for k in range(nh):
        ln = ref.h_len[k]
        assert np.array_equal(hedge[b, k, :ln], ref.h_edge[k, :ln]), (b, k)
    assert np.array_equal(nz[b, :ref.nv], ref.nonzero), b


@pytest.mark.parametrize("chunk", range(4))
def test_fuzz_states_equal_the_jax_tests_states(chunk):
    """ladder_kernel.fuzz_states builds, from the port's own modules, the
    states the JAX package's test builds from the same seeds."""
    seeds = range(chunk * 25, chunk * 25 + 25)
    _, states = ladder_kernel.fuzz_states(seeds, **SHAPE)
    _, want = ref_make_states(seeds)
    assert len(states) == len(want) > 10
    got = ladder_kernel.pack_states(states, len(states), **SHAPE)
    exp = ref_kernel.pack_states(want, len(want), **SHAPE)
    assert list(got) == list(exp) == list(ladder_kernel.ARG_NAMES)
    for k in got:
        assert got[k].dtype == exp[k].dtype, k
        assert np.array_equal(_bits(got[k]), _bits(exp[k])), k


@pytest.mark.parametrize("chunk", range(4))
def test_kernel_matches_reference(chunk):
    """100 seeded states in 4 chunks: decision logs, statuses and the
    final dense state equal the reference machine's."""
    refs, states = ladder_kernel.fuzz_states(
        range(chunk * 25, chunk * 25 + 25), **SHAPE)
    assert len(states) > 10
    counters = {}
    logs, status, finals = ladder_kernel.run_kernel(states, counters=counters,
                                                    **KW)
    assert 0 < counters["ladder_iterations"] < 4 * KW["V"] ** 2
    compared = 0
    for b, ref in enumerate(refs):
        dec, st = ladder_ref.run_ladder(ref, max_decisions=KW["DLOG"])
        if st != ladder_ref.ST_CLEAN or status[b] != 0:
            # overflow semantics: host redoes everything; only require
            # the kernel reported an overflow too when the ref overflowed
            assert status[b] != 0 or st == ladder_ref.ST_CLEAN
            continue
        assert logs[b] == dec, (b, logs[b][:8], dec[:8])
        _assert_final_state(b, ref, finals)
        compared += len(dec)
    assert compared > 50


@pytest.mark.parametrize("chunk", [0, 3])
def test_kernel_matches_jax_kernel(chunk):
    """The port's ladder against the JAX package's run_kernel on the same
    states: logs, status and every final field, ewrt on int64 views."""
    seeds = range(chunk * 25, chunk * 25 + 25)
    _, states = ladder_kernel.fuzz_states(seeds, **SHAPE)
    _, twins = ladder_kernel.fuzz_states(seeds, **SHAPE)
    logs, status, finals = ladder_kernel.run_kernel(states, **KW)
    want_logs, want_status, want_finals = ref_kernel.run_kernel(twins, **KW)
    assert logs == want_logs
    assert sum(len(lg) for lg in logs) > 50
    assert status.dtype == want_status.dtype == np.int32
    assert np.array_equal(status, want_status)
    names = ("ewrt", "ealive", "esrc", "edst", "estr", "nedges", "hedge",
             "hlen", "nz")
    for name, g, w in zip(names, finals, want_finals):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(_bits(g), _bits(w)), name


def make_broken(seed, cls=Scallop):
    """Graph with an orphaned interior vertex (exercises the broken arm,
    which flow-consistent simulate_graph output never produces), built
    from the port's modules as tests/test_ladder_kernel.py builds it."""
    rng = random.Random(seed)
    gr = simulate_graph(10, 20, 100, seed=seed)
    if gr.num_edges() == 0:
        return None
    for v in range(2, gr.num_vertices() - 2):
        ins = gr.in_edges(v)
        if ins and gr.out_degree(v) > 0:
            for e in list(ins):
                gr.remove_edge(e)
            break
    ladder_kernel._stamp(gr)
    hs = ladder_kernel._random_phase_paths(gr, rng, 4)
    hs.filter_nodes(gr)
    return cls(gr, hs, Parameters())


def _export(sc, kw):
    return ladder_ref.export_scallop(sc, emax=kw["E"], hmax=kw["H"],
                                     lmax=kw["L"])


@pytest.mark.parametrize("seed", range(12))
def test_broken_arm_three_way(seed):
    """Host Scallop (the JAX package's, logging its arms) == the port's
    reference machine == the port's kernel, and the JAX kernel on every
    third seed."""
    host = ref_make_broken(seed, LoggingScallop)
    assert host is not None
    st = _export(make_broken(seed), KW)
    assert st is not None
    run_restricted(host)
    dec, status = ladder_ref.run_ladder(st)
    assert status == ladder_ref.ST_CLEAN
    assert dec == host.declog
    assert any(arm == ladder_ref.BROKEN for arm, _ in dec)
    logs, kstatus, _ = ladder_kernel.run_kernel(
        [_export(make_broken(seed), KW)], **KW)
    assert kstatus[0] == 0 and logs[0] == dec
    if seed % 3 == 0:
        jlogs, jstatus, _ = ref_kernel.run_kernel(
            [_export(make_broken(seed), KW)], **KW)
        assert jstatus[0] == 0 and jlogs[0] == logs[0]


def test_kernel_inactive_rows():
    _, states = ladder_kernel.fuzz_states(range(3), **SHAPE)
    assert states
    n = len(states)
    alone, _, _ = ladder_kernel.run_kernel(states, **KW)
    logs, status, _ = ladder_kernel.run_kernel(
        [states[0], None] + states[1:] + [None], B=n + 2, **KW)
    assert status[1] == 0 and status[n + 1] == 0
    assert logs[1] == [] and logs[n + 1] == []
    assert [logs[0]] + logs[2:n + 1] == alone


def test_iteration_cap_reads_out_as_overflow():
    _, states = ladder_kernel.fuzz_states(range(6), **SHAPE)
    arr = ladder_kernel.pack_states(states, len(states), **SHAPE)
    out = ladder_kernel.ladder(*ladder_kernel.batch_from_numpy(arr, "cpu"),
                               DMAX=KW["DMAX"], DLOG=KW["DLOG"], maxiter=2)
    assert (out[3].numpy() == ladder_kernel.ST_OVERFLOW).all()


# ------------------------------------------------------- ladder fixtures

def _port_fixture(name):
    """The port's dense state of one ladder fixture (None where the export
    refuses it), as chip_smoke.py builds it."""
    return ladder_kernel.fixture_state(LADDER, name, E=FIX_KW["E"],
                                       H=FIX_KW["H"], L=FIX_KW["L"])


def _build_host_fixture(name):
    """The JAX package's Scallop of one ladder fixture, logging its arms,
    built by the JAX package's tests' own helpers."""
    from aletsch_tpu.config import Parameters as RefParameters
    from aletsch_tpu.core.graph_io import read_graph_reference as ref_reader
    from aletsch_tpu.scallop.hyper_set import HyperSet as RefHyperSet
    gr = ref_reader(os.path.join(LADDER, name + ".graph"))
    gr.chrm = "1"
    gr.gid = name
    gr.strand = "+"
    _stamp(gr)
    hs = RefHyperSet()
    _load_phases(name, hs)
    return LoggingScallop(gr, hs, RefParameters())


FIX_CHUNKS = 6


@pytest.mark.parametrize("chunk", range(FIX_CHUNKS))
def test_fixture_prefixes_match(chunk):
    """The device-coverable prefix of each ladder fixture: the port's
    kernel == the port's reference machine == the host Scallop, decision
    for decision; on the first chunk also == the JAX kernel."""
    names = ladder_kernel.fixture_names(LADDER)
    assert len(names) >= 100
    refs, hosts, kept = [], [], []
    for name in names[chunk::FIX_CHUNKS]:
        st = _port_fixture(name)
        if st is None or st.nv > FIX_KW["V"]:
            continue
        refs.append(st)
        hosts.append(_build_host_fixture(name))
        kept.append(name)
    assert len(kept) >= 100 // FIX_CHUNKS
    states = [_port_fixture(n) for n in kept]
    logs, status, _ = ladder_kernel.run_kernel(states, **FIX_KW)
    for i, host in enumerate(hosts):
        run_restricted(host)
        dec, st = ladder_ref.run_ladder(refs[i], max_decisions=FIX_KW["DLOG"])
        assert st == ladder_ref.ST_CLEAN and status[i] == 0, kept[i]
        assert logs[i] == dec == host.declog, (kept[i], logs[i], dec)
    if chunk == 0:
        twins = [_port_fixture(n) for n in kept]
        jlogs, jstatus, _ = ref_kernel.run_kernel(twins, **FIX_KW)
        assert jlogs == logs and np.array_equal(jstatus, status)


def test_fixtures_cover_the_arms():
    """Over all fixtures the broken, trivial and smallest arms all fire on
    the device (the counts tests/test_ladder_fixture_device.py pins)."""
    states = ladder_kernel.fixture_states(
        LADDER, **{k: FIX_KW[k] for k in "VEHL"})
    assert len(states) >= 100, "fixture coverage collapsed"
    logs, status, _ = ladder_kernel.run_kernel(states, **FIX_KW)
    assert (status == 0).all()
    fired = {ladder_ref.BROKEN: 0, ladder_ref.TRIVIAL: 0,
             ladder_ref.SMALLEST: 0}
    for lg in logs:
        for arm, _ in lg:
            fired[arm] += 1
    assert fired[ladder_ref.TRIVIAL] > 50
    assert fired[ladder_ref.SMALLEST] > 5
    assert fired[ladder_ref.BROKEN] >= 1


# ------------------------------------------------------- the batch solver

@pytest.mark.parametrize("nrows", [1, 4])
def test_solver_ships_only_the_live_rows(nrows):
    """DeviceLadder.solve(nrows): rows in the C ABI's order (uint8 flags,
    meta3 and scal split by column), stale active rows behind the live
    ones, C-contiguous int32 logs equal to run_kernel's."""
    _, states = ladder_kernel.fuzz_states(range(8), **SHAPE)
    _, twins = ladder_kernel.fuzz_states(range(8), **SHAPE)
    B = len(states)
    assert B > 4
    arr = ladder_kernel.pack_states(states, B, **SHAPE)
    dev = DeviceLadder(batch=B, maxv=KW["V"], maxe=KW["E"], maxh=KW["H"],
                       maxl=KW["L"], dmax=KW["DMAX"], dlog=KW["DLOG"],
                       device="cpu")
    assert dev.ealive.dtype == dev.nz.dtype == np.uint8
    assert dev.meta3.shape == (B, 3) and dev.scal.shape == (B, 4)
    for i in range(B):
        row = dev.row(i)
        assert len(row) == 12
        for dst, k in zip(row[:7], ladder_kernel.ARG_NAMES[:7]):
            dst[...] = arr[k][i]
        row[7][:] = (arr["nedges"][i], arr["nstamp"][i], arr["nv"][i])
        row[8][...] = arr["nz"][i]
        row[9][...] = arr["hedge"][i]
        row[10][...] = arr["hlen"][i]
        row[11][:] = (arr["jump"][i], arr["smallr"][i], arr["guard"][i],
                      arr["smin"][i])
    larm, ltgt, ndec, status = dev.solve(nrows)
    want_logs, want_status, _ = ladder_kernel.run_kernel(twins[:nrows], **KW)
    for a in (larm, ltgt, ndec, status):
        assert a.dtype == np.int32 and a.flags["C_CONTIGUOUS"]
        assert a.shape[0] == nrows
    assert larm.shape == ltgt.shape == (nrows, KW["DLOG"])
    assert np.array_equal(status, want_status)
    for b in range(nrows):
        assert [(int(larm[b, i]), int(ltgt[b, i]))
                for i in range(int(ndec[b]))] == want_logs[b]
    st = dev.stats
    assert st["ladder_dispatches"] == 1 and st["ladder_graphs"] == nrows
    assert st["ladder_decisions"] == int(ndec.sum()) > 0
    assert st["ladder_iterations"] > 0 and st["ladder_device_time"] > 0.0


def test_batch_from_numpy_types():
    _, states = ladder_kernel.fuzz_states(range(2), **SHAPE)
    arr = ladder_kernel.pack_states(states, 2, **SHAPE)
    args = ladder_kernel.batch_from_numpy(arr, "cpu")
    assert len(args) == 17
    kinds = dict(zip(ladder_kernel.ARG_NAMES, (a.dtype for a in args)))
    assert kinds["ewrt"] == kinds["jump"] == kinds["smin"] == torch.float64
    assert kinds["ealive"] == kinds["nz"] == torch.bool
    assert kinds["esrc"] == kinds["hedge"] == kinds["nv"] == torch.int32


def test_solver_on_the_cpu_runs_the_plain_loop(monkeypatch):
    """On the CPU a dispatch is the plain lockstep loop over exactly the
    live rows, never the kernel (whose route tests/test_torch_ladder_kernel.py
    covers)."""
    def refuse(*a, **k):
        raise AssertionError("the CPU solver took the kernel's route")
    monkeypatch.setattr(ladder_kernel, "ladder_cuda", refuse)
    arr = ladder_kernel.pack_states(
        ladder_kernel.fuzz_states(range(4), **SHAPE)[1][:3], 3, **SHAPE)
    dev = DeviceLadder(batch=4, maxv=KW["V"], maxe=KW["E"], maxh=KW["H"],
                       maxl=KW["L"], dmax=KW["DMAX"], dlog=KW["DLOG"],
                       device="cpu")
    dev.stage_states(arr, 3)
    rows = []
    plain = ladder_kernel.ladder_plain
    monkeypatch.setattr(ladder_kernel, "ladder_plain", lambda *a, **k: (
        rows.append(a[0].shape[0]), plain(*a, **k))[1])
    _, _, ndec, status = dev.solve(3)
    assert rows == [3] and ndec.shape == status.shape == (3,)
