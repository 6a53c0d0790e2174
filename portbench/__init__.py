"""The benchmark of the PyTorch and CUDA port (``nos_tpu_torch``).

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
metric is a file found by name: ``configs/<config>.json``,
``traffic/<mix>.json`` (its ``kind`` names the driver in ``kinds/``) and
``metrics/<metric>.py``.
"""
