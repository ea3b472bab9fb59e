"""decode.step_ms: the card's milliseconds a decode step: the span of the
pipeline's ``whisper.decode`` range over the steps the device ran (every
round's steps, and the prefill as one), from the traced batches."""


def read(run):
    span, steps = run.trace.device_span_s("whisper.decode"), run.facts.get("decode_steps", 0)
    return 1e3 * span / steps if span > 0 and steps else None
