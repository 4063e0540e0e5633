"""The benchmark of the PyTorch/CUDA port (``genie_tts_tpu_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell: a configuration (``configs/``) under a
traffic mix (``traffic/``, data) driving an entry (``entries/``), as
named by ``workloads/<cell>.json``, and prints one JSON line. Per-layer
metrics are readers in ``metrics/``, operation and byte counts in
``work/``, what a configuration's model family has of its own (its
weights' layout and scale, the system's character, its part of the
check) in ``families/``, the plain reference in ``reference/``. Every
one of those is found by its name, so a cell, configuration, family,
mix, entry or metric is added by adding files."""
