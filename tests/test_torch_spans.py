"""The port's profiler ranges and the engine's lifecycle counters (CPU,
test-nano, fp32; one case on the card, marker ``cuda``).

The benchmark's per-layer readers find the pipeline's stages by these
range names, and its traced line names the card's idle gaps by the
innermost range, the decode loop's flag reads and graph replays among
them; ``/metrics`` serves the counters. The file imports neither jax nor
the JAX package, so its card case also runs on a machine with only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from whisper_tpu_torch import decode as td
from whisper_tpu_torch.config import get_config
from whisper_tpu_torch.params import init_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving import engine as engine_mod
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer
from whisper_tpu_torch.utils import graphs
from whisper_tpu_torch.utils.profiling import profiler_trace

torch.set_num_threads(2)

CFG = get_config("test-nano")
STAGES = ("whisper.audio", "whisper.mel", "whisper.encoder", "whisper.cross_kv",
          "whisper.decode", "whisper.texts")
TICK = ("whisper.engine.prepare", "whisper.engine.step", "whisper.engine.harvest",
        "whisper.engine.admit")
WAITS = ("queue_wait_seconds_total", "ready_wait_seconds_total", "first_token_seconds_total",
         "card_wait_seconds_total")
COUNTERS = WAITS + ("prepared_total", "admitted_total", "first_tokens_total", "slot_steps_total")


def _clips(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * (1.0 + i % 3))) * 0.1).astype(np.float32)
            for i in range(n)]


def _host_ranges(prof) -> dict:
    """{name: [(start us, end us)]} of the profile's ``whisper.*`` host ranges."""
    out = {}
    for e in prof.events():
        if e.name.startswith("whisper.") and e.device_type == DeviceType.CPU:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(iv, outer) -> bool:
    return any(lo <= iv[0] and iv[1] <= hi for lo, hi in outer)


@pytest.fixture(scope="module")
def model():
    return init_params(CFG, seed=5, device="cpu")


def _pipe(model):
    return WhisperPipeline(model="test-nano", params=model, device="cpu", compute_dtype="float32",
                           language="en", max_tokens=20, temperature_fallback=False)


class _Rehearsal(graphs.GraphSet):
    """A GraphSet whose capture keeps the callable and whose replay calls it
    again: the graphed decode's control flow, and its ranges, on the CPU."""

    def _warm(self, fn):
        fn()

    def _capture(self, fn):
        return types.SimpleNamespace(replay=fn)


def test_pipeline_batch_ranges(model):
    """One ``transcribe_batch``: every stage's range once; the decode loop's
    flag read once a round (``host_syncs``), each inside ``whisper.decode``;
    no replay on the CPU, where the rounds run uncaptured."""
    pipe = _pipe(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.transcribe_batch(_clips(3))
    ranges = _host_ranges(prof)
    assert {n: len(ranges.get(n, ())) for n in STAGES} == {n: 1 for n in STAGES}
    flags = ranges["whisper.decode.flags"]
    assert pipe.last_decode.host_syncs >= 2 and len(flags) == pipe.last_decode.host_syncs
    assert all(_inside(iv, ranges["whisper.decode"]) for iv in flags)
    assert "whisper.graph.replay" not in ranges


def test_rehearsed_replays_are_ranges_inside_the_decode(model, monkeypatch):
    """The graphed decode rehearsed on the CPU: a batch's first round
    captures (no range) and every later round replays inside
    ``whisper.graph.replay``; a second batch of the shape replays every
    round. Each replay lies inside ``whisper.decode`` and precedes its
    round's flag read."""
    monkeypatch.setattr(td, "capturable", lambda model, device: True)
    monkeypatch.setattr(td, "GraphSet", _Rehearsal)
    pipe = _pipe(model)
    counts = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe.transcribe_batch(_clips(3))
        ranges = _host_ranges(prof)
        replays, flags = ranges.get("whisper.graph.replay", []), ranges["whisper.decode.flags"]
        assert all(_inside(iv, ranges["whisper.decode"]) for iv in replays)
        assert all(r[1] <= f[0] for r, f in zip(sorted(replays), sorted(flags)[-len(replays):]))
        counts.append((len(replays), pipe.last_decode.host_syncs))
    (first, rounds1), (second, rounds2) = counts
    assert rounds1 >= 2 and first == rounds1 - 1 and second == rounds2


def _engine(model, **kw):
    opts = dict(max_slots=4, compute_dtype=torch.float32, steps_per_sync=2, max_tokens=8,
                no_speech_threshold=None, logprob_threshold=None,
                compression_ratio_threshold=None)
    opts.update(kw)
    return ContinuousBatchingEngine(model, get_tokenizer(num_languages=CFG.num_languages), **opts)


class _TickClock:
    """The engine module's ``time`` with a ``perf_counter`` the test sets:
    every stamp taken within a tick reads that tick's time."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def _drive(engine, futs, limit=80, clock=None) -> tuple:
    """Tick a not-started engine until ``futs`` are done. Returns the hand
    count of slot steps (the slots occupied as each round starts times its
    steps; admission comes after the round, in the same tick) and, by the
    id of each request, the tick that first finds it in a slot. With a
    ``clock``, tick k runs at ``k`` seconds."""
    slot_steps, admitted = 0, {}
    for k in range(1, limit + 1):
        if all(f.done() for f in futs):
            return slot_steps, admitted
        if clock is not None:
            clock.now = float(k)
        occupied = sum(r is not None for r in engine._slot_req)
        engine._tick()
        slot_steps += occupied * engine.steps_per_sync
        for r in engine._slot_req:
            if r is not None:
                admitted.setdefault(id(r), k)
    raise AssertionError(f"requests not done after {limit} ticks")


def test_engine_tick_ranges(model):
    """A not-started engine's ticks: the inline prepare, the round's launch,
    the harvest and the admission each run inside their range."""
    engine = _engine(model)
    futs = [engine.submit(Request(audio=a, language="en")) for a in _clips(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):  # prepare + admit; the first round; the second + its harvest
            engine._tick()
    ranges = _host_ranges(prof)
    assert all(ranges.get(n) for n in TICK), sorted(ranges)
    assert len(ranges["whisper.engine.admit"]) == 3
    assert len(ranges["whisper.engine.step"]) == 2 and len(ranges["whisper.engine.harvest"]) == 1
    _drive(engine, futs)


def test_engine_lifecycle_counters(model, monkeypatch):
    """A burst of six requests to four slots, to completion, with tick k at
    k seconds on the engine's clock: each is prepared, admitted and shows a
    first token once; every wait is within the replies' summed walls and is
    the hand sum of its stamps. A request's first token is counted at the
    harvest two ticks after its admission (the next tick's round is its
    first; the tick after resolves that round's copy), not at the stale
    copy of the round before it. The slot steps are the hand count."""
    clock = _TickClock()
    monkeypatch.setattr(engine_mod, "time", clock)
    engine = _engine(model)
    budgets = [3, 8, 5, 8, 2, 6]
    reqs = [Request(audio=a, language="en", max_tokens=m, enqueued_at=0.0)
            for a, m in zip(_clips(len(budgets), seed=1), budgets)]
    futs = [engine.submit(r) for r in reqs]
    slot_steps, admitted = _drive(engine, futs, clock=clock)
    walls = sum(f.result(timeout=0)["wall_seconds"] for f in futs)
    s = engine.stats
    assert s.prepared_total == s.admitted_total == s.first_tokens_total == len(reqs)
    for name in WAITS:
        assert 0.0 <= getattr(s, name) <= walls, name
    assert [r.admitted_at for r in reqs] == [float(admitted[id(r)]) for r in reqs]
    assert max(admitted.values()) > min(admitted.values())  # some wait for a freed slot
    assert all(r.enqueued_at <= r.taken_at <= r.admitted_at for r in reqs)
    assert s.queue_wait_seconds_total == sum(r.taken_at - r.enqueued_at for r in reqs)
    # a batch is ready in the tick that takes it, so its wait is the taking's
    assert s.ready_wait_seconds_total == sum(r.admitted_at - r.taken_at for r in reqs)
    assert s.first_token_seconds_total == sum(admitted[id(r)] + 2 - r.enqueued_at for r in reqs)
    assert 0 < s.slot_steps_total == slot_steps <= s.steps_total * engine.B


def test_started_engine_ranges_and_metrics(model, tmp_path):
    """A started engine behind the server, profiled by ``profiler_trace``:
    the ranges of its decode and encode threads are in the trace, the
    decode thread's idle wait included, and ``GET /metrics`` serves the
    lifecycle counters."""
    engine = _engine(model).start(warm=False)
    server = make_server(engine, "127.0.0.1", 0, request_timeout_s=60)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with profiler_trace(str(tmp_path)) as path:
            futs = [engine.submit(Request(audio=a, language="en")) for a in _clips(3, seed=2)]
            for f in futs:
                f.result(timeout=60)
            time.sleep(0.2)  # the decode thread idles on the ready queue again
        url = f"http://127.0.0.1:{server.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            metrics = json.load(r)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert set(TICK) | {"whisper.engine.wait"} <= names, sorted(n for n in names if n)
    assert set(COUNTERS) <= set(metrics)
    assert metrics["prepared_total"] == metrics["admitted_total"] == 3
    assert metrics["first_tokens_total"] == 3


def test_profiler_trace_without_every_thread(tmp_path, monkeypatch):
    """A torch whose profiler config refuses ``profile_all_threads``:
    ``profiler_trace`` still writes the calling thread's trace."""

    def refuse(**kw):
        raise TypeError("unexpected keyword argument 'profile_all_threads'")

    monkeypatch.setattr(torch.profiler, "_ExperimentalConfig", refuse)
    with profiler_trace(str(tmp_path)) as path:
        with torch.profiler.record_function("whisper.test"):
            torch.ones(4).sum()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "whisper.test" in names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_replay_is_one_host_range_on_the_card(card):
    """A captured key's replay under a profile: one ``whisper.graph.replay``
    host range, and the graph's work done once."""
    x = torch.zeros(4, device=card)
    owner = graphs.GraphSet(card)
    owner.run("add", lambda: x.add_(1.0))  # the warm run (its real work) and the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        owner.run("add", lambda: x.add_(1.0))
        torch.cuda.synchronize()
    assert len(_host_ranges(prof).get("whisper.graph.replay", ())) == 1
    assert owner.replays == 1 and x.tolist() == [2.0] * 4
