"""The benchmark of ``whisper_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once and prints one JSON line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is data that the harness finds by name:
``BENCHMARK.json`` names the cell's configuration and traffic mix,
``portbench/configs/<config>.json`` holds the model's published sizes, the
precision it is served in and its ``model_type``, which names the family
module ``portbench/families/<model_type>.py`` that sizes the model, builds
the port's model and judges what it served (``spec.py`` gives the family's
functions), ``portbench/traffic/<mix>.json`` the mix's parameters (read by
the one generator in ``generate.py`` and driven by the entry its ``kind``
names under ``drivers/``), ``portbench/limits/<cell>.json`` the limits that
decide ``correct``, and ``portbench/metrics/<metric>.py`` the reader of
each per-layer metric. A model of another family is added as files: its
family module, its configuration, and a driver where the port's pipeline
and engine do not take its model. The yardstick (weights and inputs from
the seed, the plain reference, the operation and byte counts, the peaks,
the reduction of the trace) lives here too, and imports nothing of the
port; only the drivers and the families' ``port_model`` call the port.
"""
