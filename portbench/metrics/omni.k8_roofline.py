"""omni.k8_roofline: K8 (``int8_gemm_scaled``) in the language model as a
share of its roofline: the least time of the traced batches' K8 launches
in the prefill and the decode, each at its own M, K and N
(``omni_roofline.lm_k8_seconds``; the prefill's routed experts by the
routing counts), over the summed trace time of the K8
launches inside the device spans of ``whisper.omni.prefill`` and
``whisper.decode``; nothing where their number is not the one the shapes
give."""

from portbench.omni_roofline import lm_k8_seconds

KERNELS = ("int8_gemm_sm90",)
RANGES = ("whisper.omni.prefill", "whisper.decode")


def read(run):
    f = run.facts
    if not f.get("generated") or not f.get("moe"):
        return None
    spans = [iv for name in RANGES for iv in run.trace.device.get(name, ())]
    hits = [b - a for n, a, b in run.trace.ops
            if any(k in n for k in KERNELS) and any(lo <= a and b <= hi for lo, hi in spans)]
    least, launches = lm_k8_seconds(run.dims, f["batch"], len(f["generated"]) // f["batch"],
                                    f["decode_steps"], f["moe"]["prefill"])
    if not hits or len(hits) != launches:
        return None
    return 100.0 * least * 1e6 / sum(hits)
