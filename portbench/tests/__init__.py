"""CPU tests of the benchmark (run them with ``python -m pytest portbench/tests``)."""
