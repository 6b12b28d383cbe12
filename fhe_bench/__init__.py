"""The benchmark of ``lattigo_tpu_torch`` on an NVIDIA GPU: one cell a run
(``python3 -m fhe_bench.run``), driven by the files of its folders; see
``run.py``."""
