"""mfu.offline: the traced batches' model matmul work, each product at the
peak of the precision the configuration serves it in
(``roofline.offline_step_seconds``: the useful work of the tokens each row
generated), over the traced stretch's wall time."""

from portbench.roofline import offline_step_seconds


def read(run):
    b, gen = run.facts["batch"], run.facts["generated"]
    if not gen:
        return None
    least = sum(offline_step_seconds(run.dims, b, run.facts["prompt_len"], gen[i: i + b])
                for i in range(0, len(gen), b))
    return 100.0 * least / run.trace.window_s
