"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the repository root is the manifest.  One run of one
cell: ``python3 perfbench/run.py --workload <name> --seed <n> --seconds
<s> --trace <0|1>``.  Everything that belongs to one configuration, one
traffic mix or one metric is a file of its own, found by the name the
manifest gives:

* ``configs/<file>.json``   a model configuration, as it is run;
* ``workloads/<traffic>.json``   a traffic mix (its ``kind`` names the
  module under ``kinds/`` that drives it);
* ``metrics/<name>.py``   the reader of one metric.

The yardstick (peaks, operations and bytes from shapes, the trace's
arithmetic, the plain reference and the comparison that decides
``correct``) lives here, apart from the program it measures.
"""
