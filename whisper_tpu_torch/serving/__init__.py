"""Serving: the continuous-batching engine (``engine``), its HTTP front end
(``server``), the data-parallel router in front of several of them
(``router``), the entry point ``python -m whisper_tpu_torch.serving`` and a
client (``client``)."""
