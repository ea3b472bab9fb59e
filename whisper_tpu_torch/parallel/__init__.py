"""Tensor parallelism for the port: a (data, model) mesh of devices and the
split of a model's weights over its MODEL axis (``sharding``), and the
process set-up for several hosts (``distributed``)."""
