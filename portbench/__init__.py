"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line.  Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/``, its
limits in ``limits/``, its metrics' readers in ``metrics/``, its plain
reference in ``reference/`` and the driver of its traffic's kind in
``drivers/``.
"""
