"""Offline batches through ``OmniPipeline.transcribe_batch``, back to back
for the whole window: speech to token ids with a language model behind the
encoder.

Set-up builds the pipeline over this benchmark's weights (the family's
``port_model``, quantized as it is built) with the configuration's
precision, the family's prompt ids for the weight seed and the mix's
token budget, and runs ``warm_batches`` batches: the kernels load, the
decode's round is captured. The window runs batches until ``--seconds``
have passed and ends with the last one. A traced run profiles
``profile_batches`` whole batches after the window's first, with the
routing counts (``moe_stats``) reset before them and read once after each.
"""

from __future__ import annotations

import time

from .. import generate, tracing
from ..harness import Context, Outcome
from ..judge import Served
from . import launches, synchronize


def run(ctx: Context) -> Outcome:
    from whisper_tpu_torch.models.omni import moe_stats, reset_moe_stats
    from whisper_tpu_torch.omni import OmniPipeline

    mix, prec, family = ctx.cell.traffic, ctx.cell.config["precision"], ctx.cell.family
    batches = generate.offline_batches(mix, ctx.seed, ctx.device)
    prefix, suffix = family.prompt_ids(ctx.dims, ctx.weight_seed)
    pipe = OmniPipeline(
        params=family.port_model(ctx.dims, ctx.cell.config, ctx.weight_seed, ctx.device),
        prefix_ids=prefix, suffix_ids=suffix, max_tokens=mix["new_tokens"], device=ctx.device,
        **prec)
    for i in range(mix["warm_batches"]):
        pipe.transcribe_batch(batches[i % len(batches)])
    synchronize(ctx.device)
    if ctx.trace:
        tracing.warm()
    setup_s = time.perf_counter() - ctx.t0

    finished, done = [], 0
    facts = {"generated": [], "decode_steps": 0, "live_steps": 0, "batch": mix["batch"],
             "prompt_len": pipe.cfg.prompt_len, "moe": None}

    def one(record: bool = False):
        nonlocal done
        clips = batches[done % len(batches)]
        for clip, r in zip(clips, pipe.transcribe_batch(clips)):
            finished.append(Served(audio=clip, language="", tokens=r.tokens,
                                   avg_logprob=r.avg_logprob))
            if record:
                facts["generated"].append(len(r.tokens))
        if record:
            facts["decode_steps"] += pipe.last_decode.device_steps
            facts["live_steps"] += pipe.last_decode.steps
            facts["moe"] = moe_stats(pipe.model)  # since the reset: the traced batches so far
        done += 1

    def traced() -> int:
        reset_moe_stats(pipe.model)
        for _ in range(mix["profile_batches"]):
            one(record=True)
        return mix["profile_batches"]

    trace, traced_s = None, 0.0
    t0 = time.perf_counter()
    while True:
        if ctx.trace and trace is None and done == 1:  # whole batches after the first
            t = time.perf_counter()
            trace = tracing.profile(traced)
            traced_s = time.perf_counter() - t
        else:
            one()
        if time.perf_counter() - t0 - traced_s >= ctx.seconds and (trace or not ctx.trace):
            break
    wall = time.perf_counter() - t0
    audio_s = done * mix["batch"] * mix["clip_seconds"]

    earlier = {}
    if ctx.trace:
        plain = (wall - traced_s) / max(done - trace.units, 1)
        earlier = {"graph_stats": pipe.graphs.stats() if pipe.graphs else None,
                   "launches": launches(), "moe_stats": facts["moe"], "batches": done,
                   "batch_s_untraced": plain, "batch_s_traced": trace.window_s / trace.units,
                   "tracing_overhead": trace.window_s / trace.units / plain - 1.0}

    def release():
        nonlocal pipe
        pipe = None

    return Outcome(setup_s=setup_s, end_to_end={"audio_s_per_s": audio_s / wall},
                   attempted=done * mix["batch"], failed=0, finished=finished, trace=trace,
                   facts=facts, earlier=earlier, release=release)
