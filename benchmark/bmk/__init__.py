"""The benchmark's harness (benchmark/run.py is its entry point).

- spec: BENCHMARK.json, and the files it names: a cell's configuration
  (configs/<name>.json), its traffic mix (mixes/<name>.json), the readers
  of its metrics (metrics/<metric>.py) and the controls
  (controls/<name>.py), each found by name.
- window: set-up, the warm-up, the timed passes and the spans and hooks
  of a traced run.
- trace: the one profiler capture of a traced window and what is read
  from it.
- judge: the reference's run and the comparison that decides `correct`.
- roofline: the card's peaks and the kernels' bytes and operations.
"""
