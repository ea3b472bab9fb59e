"""Parallelism for the port: a (data, model) mesh of devices, the split of a
model's weights over its MODEL axis and one such split per DATA row
(``sharding``), and the process set-up for several hosts (``distributed``)."""
