"""Serving: the continuous-batching engine (``engine``), its HTTP front end
(``server``), the entry point ``python -m whisper_tpu_torch.serving`` and a
client (``client``)."""
