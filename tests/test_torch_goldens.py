"""The port (python -m aletsch_tpu_torch, in process on the CPU device)
against the upstream Aletsch v1.1.2 binary's outputs on the eight golden
cohorts of tools/refbuild/compare.py (tests/fixtures/goldens), as
tests/test_goldens.py holds the JAX package to them:

- with ALETSCH_REF_QUIRKS=1 the sorted meta GTF equals the binary's;
- in the default mode the intron-chain sets, boundaries, coverage and
  counts hold within test_goldens.py's tolerances (a superset of chains
  on the cohorts whose single-end reads the binary drops past
  max_read_span, compare.py::DEFAULT_DIVERGENT);
- with every device stage forced (the drain, bridge, support, ladder and
  similarity; their plain PyTorch forms on the CPU), on the long-read,
  mixed and single-cell cohorts at the default --max_num_exons and at 4,
  every output file is byte-identical to the JAX package's host run at
  the same --max_num_exons, the ladder carried graphs (decision for
  decision equal to the host ladder in the verify-mode case), the
  long-read cohorts exported no bridging instance, and at 4 the drain
  carried graphs.

Tolerances are test_goldens.py's: none for the bytes; for the chains, ends
exact, starts within 50 bp, coverage within 0.5, counts exact."""

import os

import pytest
import torch

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.io import bam_native as port_bam_native
from aletsch_tpu_torch.meta import device_wave, native_core
from tools.refbuild.compare import (COHORTS, DEFAULT_DIVERGENT, GOLDEN_DIR,
                                    parse_gtf, write_list)
from torch_helpers import load_reference_native, output_bytes

# every device stage forced on, each DP on the device whatever its size
FORCED = ["--device_greedy", "on", "--device_min_vertices", "2",
          "--device_min_groups", "0", "--device_bridge", "on",
          "--device_support", "on", "--device_ladder", "on",
          "--device_similarity", "on"]
DEFAULT_MAX_NUM_EXONS = "10000"
FORCED_COHORTS = ("ont2", "pacbio2", "mixed3", "smartseq8")
LONG_READ_ONLY = ("ont2", "pacbio2")
VERIFY_CASE = ("mixed3", "4")   # every stage has work here


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")
    for var in ("ALETSCH_REF_QUIRKS", "ALETSCH_FUSED_TRUST",
                "ALETSCH_DEVICE", "ALETSCH_DEVICE_GREEDY"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """{name: bams.list} of the eight cohorts, each simulated as
    compare.py simulates it for the binary."""
    assert load_reference_native() == port_bam_native.native_available()
    lists = {}
    for name in sorted(COHORTS):
        d = str(tmp_path_factory.mktemp(name))
        lists[name] = write_list(d, *COHORTS[name](d))
    return lists


def _run(main, lst, out, extra=()):
    os.makedirs(os.path.join(out, "gtf"))
    meta = os.path.join(out, "meta.gtf")
    assert main(["-i", lst, "-o", meta, "-d", os.path.join(out, "gtf"),
                 "--verbose", "0", *extra]) == 0
    return output_bytes(meta, os.path.join(out, "gtf"))


def _golden(name):
    path = os.path.join(GOLDEN_DIR, name, "ref_meta.gtf")
    assert os.path.exists(path), path
    return path


@pytest.mark.parametrize("name", sorted(COHORTS))
def test_golden_byte_parity_quirks(name, cohorts, tmp_path, monkeypatch):
    monkeypatch.setenv("ALETSCH_REF_QUIRKS", "1")
    ours = _run(port_main.main, cohorts[name], str(tmp_path / "port"))
    with open(_golden(name), "rb") as fh:
        golden = fh.read()
    assert sorted(ours["meta.gtf"].splitlines(True)) == \
        sorted(golden.splitlines(True))


@pytest.mark.parametrize("name", sorted(COHORTS))
def test_golden_chain_parity(name, cohorts, tmp_path):
    out = str(tmp_path / "port")
    _run(port_main.main, cohorts[name], out)
    ours = parse_gtf(os.path.join(out, "meta.gtf"))
    ref = parse_gtf(_golden(name))
    if name in DEFAULT_DIVERGENT:
        assert set(ref) <= set(ours), sorted(set(ref) - set(ours))
    else:
        assert set(ours) == set(ref), (
            "intron-chain set diverged from the golden: only_ref=%s "
            "only_ours=%s" % (sorted(set(ref) - set(ours)),
                              sorted(set(ours) - set(ref))))
    for k in ref:
        a, b = ref[k], ours[k]
        assert b["end"] == a["end"], k
        assert abs(b["start"] - a["start"]) <= 50, k
        assert abs(b["cov"] - a["cov"]) <= 0.5, k
        assert b["count"] == a["count"], k


def _reset_device_state():
    device_wave.reset_solvers()
    for k in device_wave.stats:
        device_wave.stats[k] = 0
    native_core.fused_stats[:] = 0
    native_core.ladder_stats[:] = 0


@pytest.mark.parametrize("name,max_num_exons", [
    (name, mne) for name in FORCED_COHORTS
    for mne in (DEFAULT_MAX_NUM_EXONS, "4")])
def test_every_stage_forced_matches_the_jax_package(name, max_num_exons,
                                                    cohorts, tmp_path,
                                                    monkeypatch):
    lst = cohorts[name]
    mne = ["--max_num_exons", max_num_exons]
    want = _run(ref_main.main, lst, str(tmp_path / "ref"),
                ["--device_greedy", "off", *mne])
    verify = (name, max_num_exons) == VERIFY_CASE
    if verify:
        monkeypatch.setenv("ALETSCH_FUSED_TRUST", "0")
    _reset_device_state()
    got = _run(port_main.main, lst, str(tmp_path / "port"), FORCED + mne)
    st = device_wave.device_stats()
    assert sorted(got) == sorted(want)
    for f in want:
        assert got[f] == want[f], "%s differs from the JAX package's" % f
    # the ladder carried graphs, each decision the host ladder's in verify
    # mode (trust mode consumes the card's log without the host's)
    assert st["device_ladder_graphs"] > 0
    assert st["ladder_dispatches"] > 0 and st["ladder_decisions"] > 0
    assert st["ladder_trust"] is not verify
    assert st["ladder_agree"] == st["ladder_total"] > 0
    if name in LONG_READ_ONLY:
        # single-end samples: no bridging phase, no instance, no dispatch
        assert st["device_bridge_insts"] == st["host_bridge_insts"] == 0
        assert st["bridge_dispatches"] == 0
    else:
        assert st["device_bridge_insts"] > 0
    if max_num_exons == "4":
        assert st["fused_graphs"] > 0 and st["fused_dispatches"] > 0
        assert st["fused_trust"] is not verify
        assert st["fused_agree"] == st["fused_total"] > 0
    else:
        # no graph reaches the greedy loop at the default
        assert st.get("fused_graphs", 0) == 0
    # no kernel launch on the CPU
    assert st["drain_launches"] == st["ladder_launches"] == \
        st["bridge_launches"] == 0
