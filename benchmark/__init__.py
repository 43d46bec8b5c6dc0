"""The benchmark of ``nomad_tpu_torch`` on NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace 0|1`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON result line. Everything that belongs to one configuration, one
traffic mix, one cell or one per-layer metric is a file of its own:

  * ``configs/<config>.json``: the model's widths, precision and source;
  * ``traffic/mixes/<traffic>.json``: the parameters of a traffic mix,
    read by the generator ``traffic/<kind>.py`` its ``kind`` names;
  * ``workloads/<cell>.json``: a cell's configuration, traffic, entry
    (``entries/<entry>.py``, which runs the system under test) and the
    limits of its correctness check;
  * ``metrics/<metric>.py``: the reader of one per-layer metric.

``reference/`` is the plain PyTorch and NumPy yardstick that decides
``correct``; ``counts.py`` and ``trace.py`` hold the operation counts,
roofline bounds and the reduction of a profiler trace. Nothing here
imports JAX or the JAX package, and ``reference/`` imports nothing of the
system under test.
"""
