"""k8_roofline: K8 (``int8_gemm_scaled``, the encoder's W8A8 products) as a
share of its roofline: the least time of a layer's six products at
M = batch x audio positions, once for every six launches, over the summed
time of its launches in the trace."""

from portbench.roofline import k8_layer_seconds

KERNELS = ("int8_gemm_sm90",)


def read(run):
    seconds, n = run.trace.kernel_seconds(KERNELS)
    if not n:
        return None
    return 100.0 * n / 6 * k8_layer_seconds(run.dims, run.facts["batch"]) / seconds
