"""The benchmark of ``gaussian_transformer_tpu_torch`` on one H100: cells
named in the repository's ``BENCHMARK.json``, run by ``perfbench/run.py``."""
