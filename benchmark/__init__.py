"""The benchmark of ``nldsc_tpu_torch``, the PyTorch and CUDA port.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by its name: ``configs/<config>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py``.  The yardstick
(``gen/``, ``work/``, ``reference/``, ``check.py``, ``trace.py``) is
frozen with the benchmark: the program is the system under test only.
"""
