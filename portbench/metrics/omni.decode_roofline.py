"""omni.decode_roofline: the decode's share of its roofline: the least time
of the traced batches' live decode steps by the bytes they must read
(``omni_roofline.decode_seconds``: every int8 weight of attention, the
fixed experts and the head, the routed experts some live row chose by the
routing counts, the KV cache the rows attend to, at 3.35 TB/s), over the
device span of ``whisper.decode``."""

from portbench.omni_roofline import decode_seconds


def read(run):
    span, f = run.trace.device_span_s("whisper.decode"), run.facts
    if span <= 0 or not f.get("live_steps") or not f.get("moe"):
        return None
    return 100.0 * decode_seconds(run.dims, f["generated"], f["live_steps"], f["moe"]) / span
