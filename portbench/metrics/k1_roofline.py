"""k1_roofline: K1 (``flash_attention_btd``, the encoder's attention) as a
share of its roofline: its least time at the batch's shapes times its
launches, over the summed time of its launches in the trace."""

from portbench.roofline import k1_seconds

KERNELS = ("attn_kernel",)


def read(run):
    seconds, n = run.trace.kernel_seconds(KERNELS)
    return 100.0 * n * k1_seconds(run.dims, run.facts["batch"]) / seconds if n else None
