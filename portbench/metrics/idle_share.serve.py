"""idle_share.serve: the share of the traced stretch in which no operation
ran on the card (``tracing.Trace.idle_share``)."""


def read(run):
    return run.trace.idle_share()
