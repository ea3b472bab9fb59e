"""host.prep_ms: the host's milliseconds a batch in the pipeline's audio
stage (``whisper.audio``: load, split, pad, copy to the card) and its text
stage (``whisper.texts``: tokens to text), from the traced batches."""


def read(run):
    t = run.trace
    host = t.host_s("whisper.audio") + t.host_s("whisper.texts")
    return 1e3 * host / t.units if host > 0 else None
