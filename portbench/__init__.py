"""The benchmark of ``lanczosplusplus_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload W --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
harness is driven by data: a cell's configuration, traffic mix, per-layer
metrics and correctness limits are files found by name (``layout``).
Nothing here imports ``jax`` or the JAX package; the plain reference
(``reference/``) imports the port neither.
"""
