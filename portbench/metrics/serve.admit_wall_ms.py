"""serve.admit_wall_ms: the wall milliseconds a request spent in the
engine's admission on its encode thread (mel, encoder, cross-KV, prefill;
``EngineStats.encode_seconds_total``, a host clock around each batch),
over the requests sent in the window before the traced stretch. The clock
counts the wait behind the step rounds on the shared stream as well as
admission's own work, so it moves with both."""


def read(run):
    n = run.facts.get("requests", 0)
    return 1e3 * run.facts["encode_seconds_total"] / n if n else None
