"""omni.prefill_ms: the card's milliseconds a batch in the omni pipeline's
``whisper.omni.prefill`` range (the language model over the 232-position
prompt: its first operation to its last), from the traced batches."""


def read(run):
    span = run.trace.device_span_s("whisper.omni.prefill")
    return 1e3 * span / run.trace.units if span > 0 else None
