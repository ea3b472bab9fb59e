"""cross_kv.ms: the card's milliseconds a batch in the pipeline's
``whisper.cross_kv`` range (its first operation to its last), from the
traced batches."""


def read(run):
    span = run.trace.device_span_s("whisper.cross_kv")
    return 1e3 * span / run.trace.units if span > 0 else None
