"""BENCHMARK.json and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
metric sits in a file of its own, so that a cell, a configuration, a mix
or a metric is added by adding files and entries, with no edit here:

- configs/<config>.json: the cohort (its builder and sizes), the
  assembler flags the configuration runs with, the warm-up cut;
- mixes/<traffic>.json: the CLI flags that choose what runs on the card
  (and an optional `env`, the variables a pass runs under), with the
  counters that must show each forced stage at work;
- metrics/<metric>.py: a reader, read(run) -> number or None, and
  optionally install(hooks) for a traced run (see window.Hooks);
- controls/<name>.py: install(), a deliberately lowered or broken path
  for the checks that the comparison catches it (run only where
  --control asks for it, never in a measured run of a cell), and
  calls(), how often it has acted.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    pass


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    """A module from a file, by path (metric files have dots in their
    names, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise SpecError("cannot load %s" % path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of BENCHMARK.json's workloads with everything it names:
    .spec (the entry), .config and .mix (the files' contents), .metrics
    ({name: entry} of the metrics this run reports: the end-to-end ones
    with --trace 0, the per-layer ones with --trace 1, each only where its
    `workloads` key, if any, lists the cell) and .readers ({name:
    module})."""

    def __init__(self, bench, name, traced, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError("no workload %r in BENCHMARK.json (have %s)"
                            % (name, ", ".join(sorted(cells))))
        self.name = name
        self.spec = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.spec["config"]]["file"]))
        self.mix = load_json(os.path.join(BENCH_DIR, "mixes",
                                          self.spec["traffic"] + ".json"))
        group = bench["per_layer"] if traced else bench["end_to_end"]
        self.metrics = {m["name"]: m for m in group
                        if name in m.get("workloads", [name])}
        self.readers = {
            m: load_module(os.path.join(BENCH_DIR, "metrics", m + ".py"),
                           "bench_metric_" + m.replace(".", "_"))
            for m in self.metrics}


def load_bench(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_control(name):
    return load_module(os.path.join(BENCH_DIR, "controls", name + ".py"),
                       "bench_control_" + name)
