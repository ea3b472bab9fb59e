"""Offline batches through ``WhisperPipeline.transcribe_batch``, back to
back for the whole window.

Set-up builds the pipeline over this benchmark's weights, with the
configuration's precision and the mix's language and token budget (the
ladder off), and runs ``warm_batches`` batches: the kernels load, the
decode graphs are captured. The window runs batches until ``--seconds``
have passed and ends with the last one, so the rate is all the audio
whose text came back over all the time it took. A traced run profiles
``profile_batches`` whole batches after the window's first.
"""

from __future__ import annotations

import time

import numpy as np

from .. import generate, tracing
from ..harness import Context, Outcome
from ..judge import Served
from . import launches, synchronize


def run(ctx: Context) -> Outcome:
    from whisper_tpu_torch.decode import graph_stats
    from whisper_tpu_torch.pipeline import WhisperPipeline

    mix, prec = ctx.cell.traffic, ctx.cell.config["precision"]
    batches = generate.offline_batches(mix, ctx.seed, ctx.device)
    pipe = WhisperPipeline(
        params=ctx.cell.family.port_model(ctx.dims, ctx.cell.config, ctx.weight_seed, ctx.device),
        language=mix["language"], max_tokens=mix["new_tokens"], temperature_fallback=False,
        device=ctx.device, **prec)
    for i in range(mix["warm_batches"]):
        pipe.transcribe_batch(batches[i % len(batches)])
    synchronize(ctx.device)
    if ctx.trace:
        tracing.warm()
    setup_s = time.perf_counter() - ctx.t0

    eot = pipe.cfg.eot
    finished, done = [], 0
    facts = {"generated": [], "decode_steps": 0, "batch": mix["batch"],
             "prompt_len": len(pipe.cfg.sot_sequence(mix["language"]))}

    def one(record: bool = False):
        nonlocal done
        clips = batches[done % len(batches)]
        results = pipe.transcribe_batch(clips)
        avg_lp = pipe.last_decode.avg_logprob.cpu().numpy()
        for clip, r, lp in zip(clips, results, avg_lp):
            toks = np.asarray(r.tokens, np.int64)
            if len(toks) < mix["new_tokens"]:  # the decode stopped at <|endoftext|>
                toks = np.append(toks, eot)
            finished.append(Served(audio=clip, language=mix["language"], tokens=toks,
                                   avg_logprob=float(lp)))
            if record:
                facts["generated"].append(len(toks))
        if record:
            facts["decode_steps"] += pipe.last_decode.device_steps + 1
        done += 1

    def traced() -> int:
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
        earlier = {"graph_stats": graph_stats(pipe.model), "launches": launches(),
                   "batches": done, "batch_s_untraced": plain,
                   "batch_s_traced": trace.window_s / trace.units,
                   "tracing_overhead": trace.window_s / trace.units / plain - 1.0}

    def release():
        nonlocal pipe
        pipe = None

    return Outcome(setup_s=setup_s, end_to_end={"audio_s_per_s": audio_s / wall},
                   attempted=done * mix["batch"], failed=0, finished=finished, trace=trace,
                   facts=facts, earlier=earlier, release=release)
