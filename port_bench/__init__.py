"""The benchmark of ``vaura_tpu_torch`` on NVIDIA cards.

    python3 -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once and prints one JSON line last on
standard output. Everything that belongs to one cell, configuration,
traffic mix or metric sits in a file of its own, found by its name:

* ``workloads/<cell>.json``: the cell's configuration, traffic mix, chips,
  why, and the limits of its output check;
* ``configs/<config>.json``: a model configuration as it is run (widths,
  dtypes, source, ``reduced`` and ``assumed``, the deployment);
* ``traffic/<mix>.json``: a traffic mix's parameters, read by the general
  generator of its ``kind`` (``traffic/<kind>.py``);
* ``metrics/<metric>.py``: one reader per metric over the run's record
  (or ``metrics/<name up to its first dot>.py``, one reader that the
  metric's ``.gen`` and ``.train`` kinds share).

``counts/`` holds the operation and byte counts from shapes and the card's
peaks, ``reference/`` the plain PyTorch reference, which imports nothing
of the program. The program is driven only through its entries
(``VauraSystem.generate``, ``train.steps.make_train_step``).
"""
