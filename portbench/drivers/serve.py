"""Requests to a ``ContinuousBatchingEngine`` in this process, in an open
loop: each request is sent when it is due on the mix's Poisson schedule
(``generate.arrivals``), whatever the engine is doing, and timed from when
it was due until its reply.

Set-up builds the engine over this benchmark's weights with the mix's
``engine`` settings and the configuration's precision, starts it (its
warm-up runs every round size and admission bucket), then sends a burst
of ``warm_requests`` requests of the mix and waits for them. The window
sends every request due in ``--seconds``; the run then waits for each, up
to ``settle_seconds`` past the close. A request that fails or never comes
counts as missing, and as an infinite latency in the percentiles. A traced
run profiles the stretch ``profile_seconds`` = [start, length] of the
window, started and stopped on the engine's decode thread between ticks
while its encode thread launches nothing; its engine counters cover the
window up to the profile's start.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import wait

import numpy as np
import torch

from .. import generate, tracing
from ..harness import Context, Outcome
from ..judge import Served
from . import launches

STATS = ("requests_total", "encode_seconds_total", "encode_batches_total", "busy_seconds_total",
         "ticks_total", "steps_total", "tokens_total")


def _pace(until: float) -> None:
    while True:
        left = until - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run(ctx: Context) -> Outcome:
    from whisper_tpu_torch.ops.quant import quantize_params
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
    from whisper_tpu_torch.tokenizer import get_tokenizer

    class Recording(ContinuousBatchingEngine):
        """The engine, noting on each request the ids its slot served
        (an ending ``<|endoftext|>`` included) where the harvest reads them,
        and running ``between`` (the profiler's start and stop) on its
        decode thread between two ticks, where no round is launching, and
        while no admission is (``quiet``, which each admission holds)."""

        quiet = threading.Lock()

        def _tick(self):
            while self.between:
                with self.quiet:
                    self.between.popleft()()
            return super()._tick()

        def _prepare_batch(self, newcomers):
            with self.quiet:
                return super()._prepare_batch(newcomers)

        def _slot_text(self, i, offs_h, tokens_h):
            req = self._slot_req[i]
            if req is not None:
                req.served_ids = np.array(tokens_h[i, self._slot_prompt_len[i]: offs_h[i]])
            return super()._slot_text(i, offs_h, tokens_h)

    mix, prec = ctx.cell.traffic, dict(ctx.cell.config["precision"])
    model = ctx.cell.family.port_model(ctx.dims, ctx.cell.config, ctx.weight_seed, ctx.device)
    if prec.pop("quantize"):
        quantize_params(model)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[prec.pop("compute_dtype")]
    prec.pop("gelu")  # the engine's decode is Whisper's exact GELU
    engine = Recording(model, get_tokenizer(num_languages=model.cfg.num_languages),
                       compute_dtype=dtype, **prec, **mix["engine"])
    del model
    engine.between = deque()
    engine.start()

    schedule = generate.arrivals(mix, ctx.seconds, ctx.seed)
    audio = generate.noise(ctx.seed, [a.samples for a in schedule], mix["amplitude"], ctx.device)
    lang = mix["language"]
    warm = [engine.submit(Request(audio=audio[i], language=lang,
                                  max_tokens=schedule[i].max_tokens))
            for i in range(min(mix["warm_requests"], len(schedule)))]
    for f in warm:
        f.result(timeout=mix["settle_seconds"])
    if ctx.trace:
        tracing.warm()
    setup_s = time.perf_counter() - ctx.t0

    n = len(schedule)
    reqs, futs, late = [None] * n, [None] * n, np.zeros(n)
    counted = {}  # a traced run's counters where its profile starts
    done_at = np.full(n, np.inf)
    before = {k: getattr(engine.stats, k) for k in STATS}
    t_open = time.perf_counter()

    def send(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            due = t_open + schedule[i].due
            _pace(due)
            reqs[i] = Request(audio=audio[i], language=lang, max_tokens=schedule[i].max_tokens)
            late[i] = time.perf_counter() - due
            futs[i] = engine.submit(reqs[i])
            futs[i].add_done_callback(lambda f, i=i: done_at.__setitem__(i, time.perf_counter()))

    if ctx.trace:
        start, length = mix["profile_seconds"]
        a, b = (int(i) for i in np.searchsorted([r.due for r in schedule],
                                                 [start, start + length]))
        prof, stopped = tracing.Profiler(host=False), threading.Event()

        def begin():
            counted.update({k: getattr(engine.stats, k) for k in STATS})
            prof.start()

        send(0, a)
        _pace(t_open + start)
        engine.between.append(begin)
        send(a, b)
        _pace(t_open + start + length)
        engine.between.append(lambda: (prof.stop(), stopped.set()))
        send(b, n)
    else:
        send(0, n)
    _pace(t_open + ctx.seconds)
    wait(futs, timeout=mix["settle_seconds"])
    trace = prof.trace(b - a) if ctx.trace and stopped.wait(mix["settle_seconds"]) else None
    after = {k: getattr(engine.stats, k) for k in STATS}
    graphs = engine._graphs.stats() if engine._graphs is not None else None
    engine.stop()

    ok = np.array([f.done() and not f.cancelled() and f.exception() is None for f in futs])
    due = t_open + np.array([a.due for a in schedule])
    latency = np.where(ok, done_at - due, np.inf)
    p50, p95 = (float(np.quantile(latency, q, method="inverted_cdf")) for q in (0.5, 0.95))
    finished = [Served(audio=audio[i], language=lang, tokens=reqs[i].served_ids,
                       avg_logprob=futs[i].result()["avg_logprob"])
                for i in range(n) if ok[i] and getattr(reqs[i], "served_ids", None) is not None]
    delta = {k: after[k] - before[k] for k in STATS}
    # a traced run's counters stop where its profile starts: the profiler's
    # stop holds the process for seconds, and the requests after it bunch up
    counters = {k: counted[k] - before[k] for k in STATS} if ctx.trace else delta
    facts = {**counters, "requests": a if ctx.trace else n, "latencies": latency.tolist(),
             "drain_s": float(done_at[ok].max() - t_open) if ok.any() else float("inf")}
    earlier = {}
    if ctx.trace:
        earlier = {"graph_stats": graphs, "launches": launches(), "requests": n,
                   "stats_delta": delta, "late_s_max": float(late.max()),
                   "late_s_p95": float(np.quantile(late, 0.95)),
                   # beside the untraced runs' p50 and p95, the tracing's cost
                   "p50_s": p50, "p95_s": p95}

    def release():
        nonlocal engine
        engine = None

    return Outcome(setup_s=setup_s,
                   end_to_end={"req_p50_s": p50, "req_p95_s": p95},
                   attempted=n, failed=int((~ok).sum()), finished=finished, trace=trace,
                   facts=facts, earlier=earlier, release=release)
