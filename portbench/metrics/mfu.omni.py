"""mfu.omni: the traced batches' useful matmul work, each product at the
peak of its precision (``omni_roofline.batch_seconds``: the encoder, the
projector, the prefill and the decode, each token through the experts it
was routed to by the routing counts), over the traced stretch's wall time."""

from portbench.omni_roofline import batch_seconds


def read(run):
    f = run.facts
    if not f.get("generated") or not f.get("moe"):
        return None
    return 100.0 * batch_seconds(run.dims, f["batch"], f["generated"], f["moe"]) / \
        run.trace.window_s
