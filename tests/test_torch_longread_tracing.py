"""The port on a long-read cohort (BASELINE.json config 4: PacBio CCS and
ONT samples in turn, aletsch_tpu_torch/cohorts.py::long_read_cohort) with
the drain, support and ladder forced onto the CPU device and the bridge
off, as the benchmark's `unbridged` mix runs them: the same bytes as the
host path; the device wave's host DP clock split by stage
(meta/device_wave.py: wave.host_dp.<stage> sum to wave.host_dp); the
ladder's row counters (ops/ladder_device.py: rows shipped, phasing paths
and their edges in the live rows); no bridge work on single-end reads;
and each sample under its protocol's parameter overlay
(config.py::Parameters.set_default)."""

import os

import pytest
import torch

from aletsch_tpu_torch import cohorts
from aletsch_tpu_torch.config import parse_all
from aletsch_tpu_torch.constants import ONT, PACBIO_CCS
from aletsch_tpu_torch.meta import device_wave
from aletsch_tpu_torch.meta.incubator import Incubator
from torch_helpers import output_bytes

COMMON = ["--max_num_exons", "8", "--verbose", "0"]
UNBRIDGED = ["--device_greedy", "on", "--device_min_vertices", "2",
             "--device_min_groups", "0", "--device_bridge", "off",
             "--device_support", "on", "--device_ladder", "on",
             "--device_similarity", "off"]
HOST = ["--device_greedy", "off", "--device_bridge", "off",
        "--device_support", "off", "--device_ladder", "off",
        "--device_similarity", "off"]
# each protocol's overlay (util/parameters.cc:508-518)
OVERLAY = {"pacbio_ccs": (PACBIO_CCS, 1, 1), "ont": (ONT, 1, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: more threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """16 genes x 2 samples (sample 0 pacbio_ccs, sample 1 ont): the
    smallest cut at which the drain, support and ladder all dispatch."""
    lst, records = cohorts.long_read_cohort(
        str(tmp_path_factory.mktemp("longread")), n_genes=16, n_samples=2)
    assert records > 0
    return lst


def _pass(lst, out, flags):
    """One pass in process, as the CLI runs it: (incubator, device stats
    of the pass, output bytes)."""
    os.makedirs(os.path.join(out, "gtf"))
    device_wave.reset_solvers()
    before = device_wave.device_stats()
    argv = ["-i", lst, "-o", os.path.join(out, "meta.gtf"), "-d",
            os.path.join(out, "gtf"), *COMMON, *flags]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALETSCH_TORCH_DEVICE", "cpu")
        inc = Incubator(parse_all(argv))
        try:
            inc.resolve()
        finally:
            if inc._pool is not None:
                inc._pool.shutdown(wait=True)
    # counters and clocks are the process's (the kernels' launch counts
    # too, which other tests in this process may have moved): the pass's
    # change of each number
    stats = {k: v - before.get(k, 0)
             if isinstance(v, (int, float)) and not isinstance(v, bool)
             else v for k, v in device_wave.device_stats().items()}
    return inc, stats, output_bytes(os.path.join(out, "meta.gtf"),
                                    os.path.join(out, "gtf"))


@pytest.fixture(scope="module")
def unbridged(cohort, tmp_path_factory):
    return _pass(cohort, str(tmp_path_factory.mktemp("unbridged")),
                 UNBRIDGED)


@pytest.fixture(scope="module")
def host(cohort, tmp_path_factory):
    return _pass(cohort, str(tmp_path_factory.mktemp("host")), HOST)


def test_the_outputs_are_the_host_paths_bytes(unbridged, host):
    got, want = unbridged[2], host[2]
    assert len(want) > 1
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_the_stage_clocks_sum_to_the_host_dp_clock(unbridged):
    pt = unbridged[0].tracer.phase_times
    parts = [pt["wave.host_dp." + s] for s in device_wave.HOST_DP_STAGES]
    assert all(p >= 0.0 for p in parts)
    assert abs(sum(parts) - pt["wave.host_dp"]) <= 1e-9
    # nested under the clock they split, and apart from the sums the
    # benchmark reads: no native consume, no solve() clock
    for s in device_wave.HOST_DP_STAGES:
        name = "wave.host_dp." + s
        assert unbridged[0].tracer.span_parent[name] == "wave.host_dp"
        assert not name.startswith("wave.consume.")
        assert not name.endswith("device_time")


def test_the_ladder_ships_at_least_its_live_rows(unbridged):
    st = unbridged[1]
    assert st["ladder_dispatches"] > 0
    assert st["ladder_rows_shipped"] >= st["ladder_graphs"] > 0


def test_long_reads_ship_phasing_paths(unbridged):
    """A full-length read phases its whole intron chain; not every graph
    has a path to phase (on this cut, mostly two-exon genes' graphs), so
    some rows ship none."""
    st = unbridged[1]
    assert st["ladder_path_edges"] >= st["ladder_paths"] > 0
    assert st["ladder_graphs"] > 0


def test_single_end_reads_give_the_bridge_nothing(unbridged):
    st = unbridged[1]
    bridge = {k: v for k, v in st.items() if "bridge" in k}
    assert "host_bridge_insts" in bridge
    assert all(v == 0 for v in bridge.values()), bridge
    assert unbridged[0].tracer.phase_times["wave.host_dp.bridge"] == 0.0
    # the forced stages did run
    assert st["fused_dispatches"] > 0 and st["device_support_groups"] > 0


@pytest.mark.parametrize("protocol", sorted(OVERLAY))
def test_each_sample_carries_its_protocols_overlay(unbridged, protocol):
    inc = unbridged[0]
    data_type, hits, junction = OVERLAY[protocol]
    samples = [sp for sp in inc.samples if sp.data_type == data_type]
    assert len(samples) == 1
    cfg = inc.params[samples[0].data_type]
    assert cfg.min_num_hits_in_bundle == hits
    assert cfg.min_junction_support == junction
