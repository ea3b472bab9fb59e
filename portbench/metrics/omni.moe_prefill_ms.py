"""omni.moe_prefill_ms: the card's milliseconds a batch in the prefill's
MoE sublayers (the summed device spans of every ``whisper.omni.moe``
range: router, fixed and routed experts, gathers and scatter-adds), from
the traced batches."""


def read(run):
    span = run.trace.device_span_s("whisper.omni.moe")
    return 1e3 * span / run.trace.units if span > 0 else None
