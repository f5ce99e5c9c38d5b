"""The benchmark of ``eigenexa_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell needs is found by name:

* ``configs/<config>.json``: the routine, dtype, n and panel widths;
* ``traffic/<mix>.json``: the mode and the matrix's parameters, read
  by the one generator in ``gen.py``;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``metrics/<metric>.py``: one reader per metric, ``read(rec)``.

``reference.py`` is the plain reference (torch and numpy only); it never
imports the program.
"""
