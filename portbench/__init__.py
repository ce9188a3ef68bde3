"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line.  Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(which names its driver in ``drivers/``), and each per-layer metric's reader
in ``metrics/<metric>.py``.  ``data/`` makes the inputs from the seed,
``reference/`` works the answers out again without the port, ``harness/``
holds the clock, the device trace and the roofline yardstick.
"""
