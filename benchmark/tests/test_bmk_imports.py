"""Nothing the harness runs imports jax or the JAX package, and the
reference imports nothing of the port.  Module names are compared by
their top-level name (the part before the first dot) as a whole name:
the port's name, aletsch_tpu_torch, begins with the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

from bmk import main as bench_main

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = {"jax", "jaxlib", "flax", "aletsch_tpu"}
PORT = "aletsch_tpu_torch"


def top(name):
    return name.split(".")[0]


def imported_tops(path):
    """Top-level names of a source file's absolute imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top(node.module))
    return out


def sources(*dirs):
    for d in dirs:
        for base, _, files in os.walk(os.path.join(BENCH, d)):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(base, f)


def test_top_level_names_compare_whole():
    assert top("aletsch_tpu_torch.ops.drain") == PORT
    assert top("aletsch_tpu_torch") not in JAX_SIDE
    assert top("aletsch_tpu.ops") in JAX_SIDE
    assert top("jaxlib.xla_client") in JAX_SIDE
    assert top("jaxtyping") not in JAX_SIDE


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {p: imported_tops(p) & JAX_SIDE
             for p in sources("bmk", "metrics", "controls", "cohortgen",
                              "refasm")}
    found[os.path.join(BENCH, "run.py")] = \
        imported_tops(os.path.join(BENCH, "run.py")) & JAX_SIDE
    assert not any(found.values()), found


def test_the_reference_and_the_generator_import_nothing_of_the_port():
    found = {p: imported_tops(p) & ({PORT} | JAX_SIDE)
             for p in sources("refasm", "cohortgen")}
    assert not any(found.values()), found
    found = {p: imported_tops(p) & {PORT}
             for p in sources("bmk") if p.endswith(("drain_ref.py",
                                                    "roofline.py",
                                                    "judge.py"))}
    assert not any(found.values()), found


def test_the_reference_run_loads_nothing_of_the_port(tmp_path):
    """The reference's process, over a small cohort, holds no module of
    the port, of the JAX package or of jax when it has run."""
    from cohortgen import cohorts
    lst, _ = cohorts.paired_end_cohort(str(tmp_path / "c"), 6, 2)
    code = ("import json, runpy, sys\n"
            "sys.argv = ['refasm'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('refasm', run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print(json.dumps(sorted({m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None})))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, lst, str(tmp_path / "out"),
         "--max_num_exons", "8", "--verbose", "0"], cwd=BENCH,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=BENCH))
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "refasm" in names
    assert not names & ({PORT} | JAX_SIDE), names & ({PORT} | JAX_SIDE)
    assert os.path.exists(tmp_path / "out" / "meta.gtf")


def test_the_harness_refuses_a_result_with_a_jax_module_loaded(monkeypatch):
    before = set(bench_main.forbidden_modules())
    monkeypatch.setitem(sys.modules, "aletsch_tpu_torch_shadow",
                        sys.modules[__name__])
    assert set(bench_main.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "aletsch_tpu.fake",
                        sys.modules[__name__])
    assert set(bench_main.forbidden_modules()) == before | {"aletsch_tpu"}


@pytest.mark.parametrize("mod", sorted(JAX_SIDE))
def test_each_forbidden_name_is_caught(monkeypatch, mod):
    before = set(bench_main.forbidden_modules())
    monkeypatch.setitem(sys.modules, mod + ".x", sys.modules[__name__])
    assert set(bench_main.forbidden_modules()) == before | {mod}
