"""The benchmark of ``hamilton_tpu_torch`` on one NVIDIA H100.

``BENCHMARK.json`` at the root of the checkout names the cells; ``run.py``
runs one cell once (``python3 -m port_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``); ``check.py`` decides ``correct`` against the
plain reference in ``reference/``; ``control.py`` runs the lower-precision
control.  Every configuration, traffic mix, cell limit, frozen cost and
per-layer reader is a file of its own that the harness finds by name
(``spec.py``).  Nothing here imports JAX or the JAX package.
"""
