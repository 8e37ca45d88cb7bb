"""The port's host modules against the JAX package's, file by file.

aletsch_tpu_torch imports nothing of aletsch_tpu: it keeps its own copy of
every host module it runs, under the same sub-package and file name.  These
tests guard the copies against drift.  A plain copy must equal its original
once the package name is rewritten.  Two wordings of docstrings are
brought in line, each by a pattern tied to its one context so that it can
hide no other difference: the absolute mount point that five module
docstrings give in brackets for the upstream C++ sources is dropped, and
the offline replay program of native/replay_batch.cpp is called a
harness.  A seam module, which differs on purpose, must equal its original in every function but
the ones named here (those that differ, those it leaves out and those it
adds), and the behaviour behind the seam is held to the JAX package's on
seeded inputs.  A fix to a host module of the reference goes
into the copy in the same change, or these fail.
"""

import ast
import os
import re

import numpy as np
import pytest

from aletsch_tpu import __main__ as ref_main
from aletsch_tpu.config import default_params
from aletsch_tpu.meta import bundle_group as ref_bundle_group
from aletsch_tpu.ops import bridge_topk as ref_bridge
from aletsch_tpu.ops import ladder_device as ref_ladder_device
from aletsch_tpu.ops import ladder_kernel as ref_ladder
from aletsch_tpu.ops import ladder_ref as ref_ladder_ref
from aletsch_tpu.ops import similarity as ref_similarity
from aletsch_tpu.ops import support as ref_support
from aletsch_tpu.utils import tracing as ref_tracing
from aletsch_tpu_torch import __main__ as port_main
from aletsch_tpu_torch.meta import bundle_group as port_bundle_group
from aletsch_tpu_torch.meta import device_wave as port_wave
from aletsch_tpu_torch.ops import bridge_topk as port_bridge
from aletsch_tpu_torch.ops import constants as port_constants
from aletsch_tpu_torch.ops import ladder_device as port_ladder_device
from aletsch_tpu_torch.ops import ladder_kernel as port_ladder
from aletsch_tpu_torch.ops import ladder_ref as port_ladder_ref
from aletsch_tpu_torch.ops import similarity as port_similarity
from aletsch_tpu_torch.ops import support as port_support
from aletsch_tpu_torch.utils import tracing as port_tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "aletsch_tpu", "aletsch_tpu_torch"

PLAIN_COPIES = [
    "constants.py", "config.py", "utils/intervals.py", "utils/seqs.py",
    "io/bgzf.py", "io/bam.py", "io/gtf.py",
    "core/bundle.py", "core/chain_set.py", "core/essential.py",
    "core/graph.py", "core/graph_builder.py", "core/graph_cluster.py",
    "core/graph_io.py", "core/graph_reviser.py", "core/hits.py",
    "core/paths.py", "core/regions.py", "core/transcript_set.py",
    "bridge/solver.py", "bridge/solver_types.py",
    "scallop/decompose.py", "scallop/hyper_set.py", "scallop/router.py",
    "scallop/subsetsum.py", "scallop/ugraph.py",
    "meta/bundle.py", "meta/transcript_store.py", "meta/sample_profile.py",
    "meta/previewer.py", "meta/generator.py", "meta/native_tset.py",
    "meta/native_core.py", "meta/assembler.py",
    "ops/ladder_ref.py", "parallel/wave_extract.py", "sim.py",
    "core/filters.py", "core/draw.py", "core/bridged_bam.py",
    "utils/stats.py", "scoring/__init__.py", "scoring/score.py",
    "scoring/train.py", "parallel/distributed.py", "parallel/worker.py",
]

# seam module -> (definitions that differ on purpose, definitions the
# original has and the copy leaves out, definitions the copy adds)
SEAMS = {
    # a torch.profiler trace where the original takes a jax.profiler one,
    # and the count of its device records against their enqueueing calls;
    # spans inside the phases, a record_function range each under a
    # capture, with their regions in the trace's args
    "utils/tracing.py": (
        {"Tracer.start_jax_trace", "Tracer.stop_jax_trace",
         "Tracer.__init__", "Tracer.phase", "Tracer.summary"}, set(),
        {"read_trace", "device_counts", "_profiler", "add_regions",
         "Tracer._stack", "Tracer._nest", "Tracer.span", "Tracer.region",
         "Tracer.add_time", "Tracer.tile_from", "Tracer.summary.show",
         "Tracer._write_trace"}),
    # the descent runs as PyTorch on the port's device, with no fallback to
    # numpy; a numpy-built forest for hosts without sklearn
    "scoring/forest.py": (
        {"predict_proba"},
        {"_get_jax_predict", "_get_jax_predict.predict",
         "_get_jax_predict.predict.body"},
        {"_get_torch_predict", "_get_torch_predict.predict",
         "_get_torch_predict.predict.up", "synthetic_forest"}),
    # the workers' bytecode cache follows TMPDIR
    "parallel/jobs.py": ({"_spawn_worker"}, set(), set()),
    # the device forms are PyTorch on the port's device: no jitted
    # functions to cache, no shape buckets
    "ops/similarity.py": (
        {"pairwise_splice_similarity", "_intersection_matrix_device",
         "_pairs_device_sparse"},
        {"_get_jax_fn", "_get_jax_fn.fn", "_pad", "_get_sparse_fn",
         "_get_sparse_fn.fn", "_pad_nnz"},
        {"_counts", "_sparse_candidates"}),
    # 'auto' asks similarity's own fit at the region's size
    "meta/bundle_group.py": (
        {"BundleGroup._use_device_similarity"}, set(), set()),
    # the device wave takes the tracer; spans of the region pipeline on
    # its two threads (utils/tracing.py::Tracer.span); the replay thread
    # runs the device waves queued together as one (ReplayQueue)
    "meta/incubator.py": (
        {"Incubator._assemble_groups", "Incubator._run_region_pipeline",
         "Incubator._run_region_pipeline.get_result",
         "Incubator._run_region_pipeline._finish_one",
         "Incubator._run_region_pipeline._replay_worker",
         "Incubator.process_region", "Incubator._region_start",
         "Incubator._region_finish"}, set(),
        {"_region_id", "Incubator._assemble_waves", "ReplayQueue.__init__",
         "ReplayQueue.put", "ReplayQueue.get", "ReplayQueue.task_done",
         "ReplayQueue.join"}),
    "__main__.py": ({"main"}, set(), set()),
    # the port builds its own library, under a lock and renamed into place
    # (tests/test_torch_native_build.py), and loads it once a process
    "io/bam_native.py": ({"_load_lib"}, set(), {"_build_lib", "_open_lib"}),
    # a list of torch devices in place of a jax Mesh: the solvers run once a
    # chunk on its device and join the rows
    "ops/meshing.py": ({"get_mesh", "shard_args", "account_out"}, set(),
                       {"_local_devices", "join_rows"}),
    # a torch.distributed gloo group; the port's device is kept
    "parallel/jaxdist.py": (
        {"_allgather_bytes", "launch_jax_distributed",
         "run_jax_distributed"}, set(), set()),
    # the port's mesh and device; torch.cuda.synchronize on a card
    "parallel/scaling.py": (
        {"measure_scaling", "measure_scaling_shape",
         "measure_scaling_shape.timed", "main"}, set(), {"_devices", "_sync"}),
    # the root __graft_entry__.py of the JAX package
    "graft_entry.py": (
        {"entry", "dryrun_multichip", "_dryrun_incubator_mesh",
         "_dryrun_incubator_mesh.run"}, set(), set()),
}
# a seam whose original lies elsewhere than at the same path in aletsch_tpu/
ORIGINAL = {"graft_entry.py": os.path.join(os.pardir, "__graft_entry__.py")}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("ALETSCH_TORCH_DEVICE", "cpu")


def _read(pkg, rel):
    with open(os.path.join(REPO, pkg, rel)) as fh:
        return fh.read()


def _as_copied(src):
    """The original's text as the copy holds it."""
    src = re.sub(r"aletsch_tpu(?!_torch)", PORT, src)
    src = re.sub(r"\(/[a-z]+/reference/", "(", src)
    return re.sub(r"(gprof replay) [a-z]+( \(native/replay_batch\.cpp\))",
                  r"\1 harness\2", src)


def _defs(src):
    """{qualified name: source} of every function, method and nested
    function of a module."""
    out = {}

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                name = prefix + child.name
                if isinstance(child, ast.FunctionDef):
                    out[name] = ast.get_source_segment(src, child)
                walk(child, name + ".")
            else:
                walk(child, prefix)

    walk(ast.parse(src), "")
    return out


@pytest.mark.parametrize("rel", PLAIN_COPIES)
def test_plain_copy_equals_original(rel):
    assert _read(PORT, rel) == _as_copied(_read(REF, rel))


@pytest.mark.parametrize("rel", sorted(SEAMS))
def test_seam_module_differs_only_where_named(rel):
    differ, left_out, added = SEAMS[rel]
    ref = _defs(_as_copied(_read(REF, ORIGINAL.get(rel, rel))))
    port = _defs(_read(PORT, rel))
    assert set(ref) - set(port) == left_out
    assert set(port) - set(ref) == added
    changed = {name for name in set(port) & set(ref)
               if port[name] != ref[name]}
    assert changed == differ


def test_every_host_module_of_the_port_is_listed():
    """Each Python module of the port is a plain copy, a seam, or one of
    the port's own device-side modules."""
    own = {"__init__.py", "device.py", "meta/device_wave.py",
           "ops/_build.py", "ops/bottleneck.py", "ops/constants.py",
           "ops/drain.py", "ops/greedy_dp.py", "ops/greedy_fused.py",
           "ops/_replay.py", "ops/bridge_topk.py", "ops/support.py",
           "ops/ladder_kernel.py",
           "ops/ladder_device.py", "ops/coverage.py", "ops/bridge_dp.py",
           "ops/mfu.py", "ops/crossover.py", "parallel/mesh.py",
           "cohorts.py"}
    found = set()
    pkg = os.path.join(REPO, PORT)
    for d, _, files in os.walk(pkg):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), pkg)
            if f.endswith(".py") and f != "__init__.py":
                found.add(rel.replace(os.sep, "/"))
            elif f == "__init__.py" and d != pkg:
                # sub-package markers: empty in the original, and a
                # docstring at most here
                assert ast.parse(_read(PORT, rel)).body[1:] == []
    assert found == {rel for rel in set(PLAIN_COPIES) | set(SEAMS) | own
                     if os.path.basename(rel) != "__init__.py"}


BRIDGE_NAMES = ("K", "S", "BIG", "SENTINEL", "DEFAULT_B", "DEFAULT_V",
                "DEFAULT_E", "DEFAULT_T")
SUPPORT_NAMES = ("DEFAULT_B", "DEFAULT_NS", "DEFAULT_J")
LADDER_NAMES = ("DEFAULT_B", "DEFAULT_V", "DEFAULT_E", "DEFAULT_H",
                "DEFAULT_L", "DEFAULT_DMAX", "DEFAULT_DLOG", "PC_BROKEN",
                "PC_FAST", "PC_TV1", "PC_SMALL", "PC_DECOMP", "PC_DONE",
                "ST_RUN", "ST_CLEAN", "ST_OVERFLOW", "INF", "BIGI", "BROKEN",
                "TRIVIAL", "SMALLEST")
LADDER_REF_NAMES = ("BROKEN", "TRIVIAL", "SMALLEST", "ST_CLEAN",
                    "ST_OVERFLOW", "ST_INELIGIBLE")


@pytest.mark.parametrize("ref,port,names", [
    (ref_bridge, port_bridge, BRIDGE_NAMES),
    (ref_support, port_support, SUPPORT_NAMES),
    (ref_ladder, port_ladder, LADDER_NAMES),
    (ref_ladder_ref, port_ladder_ref, LADDER_REF_NAMES),
], ids=["bridge", "support", "ladder", "ladder_ref"])
def test_device_dp_constants_match_jax(ref, port, names):
    """The bridge, support and ladder constants of the port equal the JAX
    package's, value and type."""
    for name in names:
        want, got = getattr(ref, name), getattr(port, name)
        assert got == want and type(got) is type(want), name


def test_bridge_and_support_constants_live_in_ops_constants():
    c = port_constants
    assert (c.BRIDGE_K, c.BRIDGE_S, c.BRIDGE_BIG, c.BRIDGE_SENTINEL) == \
        (ref_bridge.K, ref_bridge.S, int(ref_bridge.BIG),
         ref_bridge.SENTINEL) == (10, 5, 2 ** 30, 999999)
    assert (c.BRIDGE_B, c.BRIDGE_V, c.BRIDGE_E, c.BRIDGE_T) == \
        (64, 64, 16, 16)
    assert (c.SUPPORT_B, c.SUPPORT_NS, c.SUPPORT_J) == (64, 16, 64)
    assert c.LADDER_B == port_ladder.DEFAULT_B == ref_ladder.DEFAULT_B == 64


def test_ladder_solver_shapes_match_jax():
    """DeviceLadder's defaults, its staging dtypes and the order of row(i)
    are the JAX package's (the native export's C ABI); read from the
    reference's source, since building its solver compiles the kernel."""
    import inspect
    ref_init = inspect.signature(ref_ladder_device.DeviceLadder.__init__)
    port_init = inspect.signature(port_ladder_device.DeviceLadder.__init__)
    ref_defaults = {k: v.default for k, v in ref_init.parameters.items()
                    if k != "self"}
    port_defaults = {k: v.default for k, v in port_init.parameters.items()
                     if k not in ("self", "device")}
    assert port_defaults == ref_defaults
    dev = port_ladder_device.DeviceLadder(batch=2, device="cpu")
    src = inspect.getsource(ref_ladder_device.DeviceLadder)
    row = re.search(r"def row\(self, i\):.*?return \((.*?)\)\n", src,
                    re.S).group(1)
    order = re.findall(r"self\.(\w+)\[i\]", row)
    assert len(order) == 12
    for field, got in zip(order, dev.row(1)):
        want = re.search(r"self\.%s = np\.\w+\(\((.*?)\), .*?np\.(\w+)\)"
                         % field, src, re.S)
        assert got.dtype == np.dtype(want.group(2)), field
        assert got.base is not None and \
            np.shares_memory(got, getattr(dev, field)), field
        assert got.ndim == want.group(1).count(","), field


def _splice_lists(rng, n, n_pos, dup=0.3):
    """n splice sets over n_pos positions, some of them duplicates or
    subsets of earlier ones so that ratios tie and reach 1.0."""
    lists = []
    for i in range(n):
        if i and rng.random() < dup:
            base = lists[int(rng.integers(0, i))]
            keep = max(1, int(len(base) * rng.random()))
            lists.append(sorted(rng.choice(base, size=keep, replace=False)
                                .tolist()) if base else [])
        else:
            k = int(rng.integers(0, min(9, n_pos + 1)))
            lists.append(sorted(rng.choice(n_pos, size=k, replace=False)
                                .tolist()))
    return lists


@pytest.mark.parametrize("n,n_pos,seed", [(2, 6, 0), (17, 30, 1),
                                          (47, 60, 2), (48, 60, 3),
                                          (130, 200, 4), (300, 150, 5)])
@pytest.mark.parametrize("min_similarity", [0.2, 0.9])
def test_similarity_pair_lists_equal(n, n_pos, seed, min_similarity):
    """The port gives the JAX package's pair lists exactly, below 48
    bundles (the host form of both) and from 48 up (the device forms of
    both, PyTorch and XLA on the CPU here): same pairs, same order, same
    floats."""
    lists = _splice_lists(np.random.default_rng(seed), n, n_pos)
    want = ref_similarity.pairwise_splice_similarity(lists, min_similarity)
    got = port_similarity.pairwise_splice_similarity(lists, min_similarity)
    assert got == want
    assert n < 10 or len(got) > 0


def test_similarity_trivial_inputs():
    for lists in ([], [[1, 2]], [[], []]):
        assert port_similarity.pairwise_splice_similarity(lists, 0.2) == \
            ref_similarity.pairwise_splice_similarity(lists, 0.2) == []


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("n_bundles", [3, 64])
def test_similarity_gate_agrees(mode, env, n_bundles, monkeypatch):
    """BundleGroup._use_device_similarity asks each package's own
    device_wave.auto_device_ok (the port's about similarity's own fit); on
    a CPU backend and on the port's CPU device both say no."""
    if env is None:
        monkeypatch.delenv("ALETSCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("ALETSCH_DEVICE", env)
    cfg = default_params()[0]
    cfg.device_similarity = mode
    answers = []
    for mod in (ref_bundle_group, port_bundle_group):
        g = mod.BundleGroup("chr1", "+", 0, cfg, {})
        g.gset = [None] * n_bundles
        answers.append(g._use_device_similarity())
    assert answers[0] == answers[1]
    assert port_wave.auto_device_ok(cfg, n_bundles, "similarity") is False


def test_tracer_prints_what_the_jax_package_prints():
    """The port's Tracer prints what the JAX package's prints, and with no
    directory its trace hooks do nothing."""
    import io
    out = []
    for mod in (ref_tracing, port_tracing):
        buf = io.StringIO()
        tr = mod.Tracer(verbose=3, stream=buf)
        tr.add("bundles", 3)
        tr.region_line("chr1", 2, 5, 4)
        tr.group_line("chr1", "+", 2, 7, 3)
        tr.start_jax_trace()        # no directory: nothing happens
        tr.stop_jax_trace()
        out.append(buf.getvalue().replace(
            "rss=%.0fMB" % mod.rss_mb(), "rss"))
        assert tr.counters == {"bundles": 3}
        assert tr._jax_active is False
    assert out[0].split("rss")[0] == out[1].split("rss")[0]
    assert port_tracing.NullTracer().verbose == 0


@pytest.mark.parametrize("argv", [
    ["-i", "a", "-o", "b"],
    ["--jobs", "3", "-i", "a"],
    ["--shard", "1", "4", "--shard_dump", "d.pkl", "-o", "b"],
    ["--merge_shards", "a,b,c"],
    ["--jax_dist", "0", "2", "localhost:1234", "-i", "a"],
    ["--jax_dist_launch", "2", "--verbose", "1"],
])
def test_extract_shard_args_equal(argv):
    assert port_main._extract_shard_args(list(argv)) == \
        ref_main._extract_shard_args(list(argv))
