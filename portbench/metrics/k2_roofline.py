"""k2_roofline: K2 (``cross_attention_decode_fd``, the decode step's int8
cross-attention) as a share of its roofline: its least time at the batch's
rows times its launches, over the summed time of its launches in the trace."""

from portbench.roofline import k2_seconds

KERNELS = ("fd_kernel",)


def read(run):
    seconds, n = run.trace.kernel_seconds(KERNELS)
    return 100.0 * n * k2_seconds(run.dims, run.facts["batch"]) / seconds if n else None
