"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the sizes, the data generator and the plain
  reference (``reference/<name>.py``) of a configuration;
* ``workloads/<cell>.json``: the cell's configuration, traffic mix and
  the limits of its correctness check;
* ``traffic/<traffic>.json``: a traffic mix's parameters, read by the
  general generator of its kind, ``traffic/<kind>.py``;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports JAX or the JAX package ``repro``; the reference
imports nothing of ``repro_torch``.
"""
