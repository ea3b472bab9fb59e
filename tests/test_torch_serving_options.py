"""The serving engine's greedy options in the port, against the JAX engine
(CPU, test-nano and a wide text-context variant, fp32, int8 cross- and
self-KV, the same bridged weights): timestamps, ``initial_prompt`` prompts
on the slots and on the aux worker, adaptive round sizes, the segmented
admission encode, the encode thread and ``on_partial`` streaming.

Rounds are driven with ``_tick()`` on both engines (neither is started, so
both prepare inline), so admissions land on the same ticks; threaded tests
wait with timeouts. Tokens must be equal; a difference is reported with the
port's top-2 logit margin at the first differing step, as
``tests/test_torch_serving.py`` does.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import WhisperConfig as JaxConfig
from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import encode_cross_kv
from whisper_tpu_torch.models.model import KVCache, decoder_forward
from whisper_tpu_torch.ops.mel import log_mel_batch
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving import engine as engine_mod
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
# test-nano with turbo's 448-position text context: a 100-token budget
# buckets the slot cache to 128 positions, so the context cap
# (kv_ctx - 13 = 115) binds below OpenAI's n_text_ctx // 2 - 1 = 223
WIDE = dict(name="serve-wide", n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2,
            n_text_layer=2)
ENGINE = dict(max_slots=4, steps_per_sync=2, max_tokens=8, kv_quant=True, self_kv_quant=True,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
SEED = 3  # weights whose greedy decodes differ from clip to clip


class IdTok:
    """Decodes to the ids themselves (timestamps included), so a reply
    carries its tokens; encodes prompts and suppresses non-speech as the
    real tokenizer does."""

    def __init__(self):
        tok = get_tokenizer(num_languages=PCFG.num_languages)
        self.non_speech_tokens = tok.non_speech_tokens
        self.encode = tok.encode

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode


def _ids(res: dict):
    return [int(t) for t in res["text"].split()]


@pytest.fixture(scope="module")
def nano():
    return jm.init_params(CFG, jax.random.PRNGKey(SEED)), CFG, PCFG


@pytest.fixture(scope="module")
def wide():
    cfg = JaxConfig(**WIDE)
    return jm.init_params(cfg, jax.random.PRNGKey(SEED)), cfg, WhisperConfig(**WIDE)


def _engines(params, **kw):
    """(port engine, JAX engine) on the same weights and options."""
    jp, cfg, pcfg = params
    opts = {**ENGINE, **kw}
    model = from_jax_params(jax.tree.map(np.asarray, jp), pcfg, device="cpu")
    port = ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32, **opts)
    jeng = JaxEngine(jp, cfg, IdTok(), compute_dtype=jnp.float32, **opts)
    return port, jeng


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _run(engines_futs, limit=120, each_tick=None):
    """Tick every engine until all its futures are done."""
    for _ in range(limit):
        if all(f.done() for _, futs in engines_futs for f in futs):
            return
        for eng, _ in engines_futs:
            eng._tick()
        if each_tick is not None:
            each_tick()
    raise AssertionError(f"requests not done after {limit} ticks")


def _both(params, reqs, engine_kw=None, arrivals=None, each_tick=None):
    """Submit ``reqs`` (Request keyword dicts) to a port and a JAX engine,
    at the ticks ``arrivals`` gives (all before the first by default), and
    run both to the end. Returns (port replies, JAX replies, port engine)."""
    port, jeng = _engines(params, **(engine_kw or {}))
    arrivals = arrivals or {0: list(range(len(reqs)))}
    got, want = [None] * len(reqs), [None] * len(reqs)
    for tick in range(200):
        for i in arrivals.get(tick, []):
            got[i] = port.submit(Request(**reqs[i]))
            want[i] = jeng.submit(JaxRequest(**reqs[i]))
        if tick > max(arrivals) and all(f.done() for f in got + want):
            break
        port._tick()
        jeng._tick()
        if each_tick is not None:
            each_tick(port)
    return [f.result(0) for f in got], [f.result(0) for f in want], port


def _margin(model, pcfg, clip, prefix):
    """The port's top-2 logit margin after ``prefix``, teacher-forced on
    ``clip`` (fp32 cross-KV): how near a tie the step was."""
    audio = np.zeros((1, 480000), np.float32)
    audio[0, : len(clip)] = clip[:480000]
    mel = log_mel_batch(torch.from_numpy(audio), torch.tensor([min(len(clip), 480000)]),
                        n_mels=pcfg.n_mels)[..., : 2 * pcfg.n_audio_ctx]
    logits, _ = decoder_forward(model, torch.tensor([prefix]), 0,
                                KVCache.create(pcfg, 1, device="cpu"),
                                encode_cross_kv(model, mel))
    top2 = torch.topk(logits[0, -1], 2).values
    return float(top2[0] - top2[1])


def _assert_tokens_equal(got, want, port, reqs, prompts):
    """Equal ids row by row; else fail naming the first differing step and
    the port's margin there (``prompts[i]``: row i's prompt, unpadded)."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _ids(g), _ids(w)
        if g != w:
            t = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
            m = _margin(port.model, port.cfg, reqs[i]["audio"], list(prompts[i]) + w[:t])
            pytest.fail(f"row {i} differs from JAX at token {t} (port {g[t:t + 1]}, JAX "
                        f"{w[t:t + 1]}), top-2 margin {m:.3g}")


def _sot(pcfg, timestamps=False):
    seq = list(pcfg.sot_sequence("zh"))
    return seq[:-1] if timestamps else seq


def _context(port, req: dict):
    ids = port._context_ids(Request(audio=req["audio"], initial_prompt=req.get("initial_prompt")))
    return [port.cfg.sot_prev, *ids] if ids else []


# ---------------------------------------------------------------- timestamps
def test_engine_timestamps_mode(nano):
    """timestamps=True: 3-token prompts (no <|notimestamps|>), the timestamp
    grammar in the prefill and every step; tokens equal JAX's, and every
    decode opens with a timestamp, as the grammar forces."""
    clips = _clips(31, (0.7, 2.0, 1.3, 3.1))
    reqs = [dict(audio=c, language="zh") for c in clips]
    got, want, port = _both(nano, reqs, dict(timestamps=True), arrivals={0: [0, 1], 2: [2, 3]})
    _assert_tokens_equal(got, want, port, reqs, [_sot(PCFG, True)] * 4)
    assert all(_ids(r) and _ids(r)[0] >= PCFG.timestamp_begin for r in got)
    assert port._slot_prompt_len == [0] * 4 and port.stats.requests_total == 4


def test_timestamps_on_the_aux_worker(nano):
    """A sampled request under timestamps=True decodes on the aux worker
    with the timestamp grammar and 3-token prompts, and its text keeps the
    timestamp tokens."""
    port, _ = _engines(nano, timestamps=True)
    fut = port.submit(Request(audio=_clips(32, (1.1,))[0], language="zh", temperature=0.7))
    assert port.aux_round() == 1
    ids = _ids(fut.result(0))
    assert ids and ids[0] >= PCFG.timestamp_begin and fut.result(0)["temperature"] == 0.7


# ---------------------------------------------------------------- prompts
PROMPTS = {"short": "hello world",
           "medium": "the quick brown fox, 1843",
           "cap": "Ada and Grace talk about engines, looms and cards for a long while " * 4}


@pytest.mark.parametrize("prompt", list(PROMPTS))
def test_engine_initial_prompt_matches_jax(nano, prompt):
    """A prompted and a plain request of the same clip in one admission:
    [pad, sot_prev, context, sot sequence] rows behind per-slot pads (the
    cap: 15 context tokens, n_text_ctx // 2 - 1); tokens equal JAX's, and
    the context changed the decode of at least one prompt."""
    clip = _clips(33, (1.4,))[0]
    reqs = [dict(audio=clip, language="zh", initial_prompt=PROMPTS[prompt]),
            dict(audio=clip, language="zh")]
    got, want, port = _both(nano, reqs)
    ctx = _context(port, reqs[0])
    _assert_tokens_equal(got, want, port, reqs, [ctx + _sot(PCFG), _sot(PCFG)])
    assert len(ctx) - 1 == min(len(IdTok().encode(" " + PROMPTS[prompt].strip())), 15)
    if prompt == "short":
        assert _ids(got[0]) != _ids(got[1]), "the context changed nothing"


def test_mixed_prompted_and_unprompted_admission(wide):
    """One admission batch of an unprompted row and contexts of 3, about 40
    and the capped 115 tokens (wide config, kv_ctx 128): one prompt width
    of 1 + 115 + 4, per-row pads, the no-speech probability read at the
    shared sot column; tokens and no-speech probabilities equal JAX's."""
    clips = _clips(34, (0.8, 1.6, 2.4, 1.2))
    texts = [None, "hi there", PROMPTS["cap"][:150], PROMPTS["cap"] * 3]
    reqs = [dict(audio=c, language="zh", initial_prompt=t) for c, t in zip(clips, texts)]
    pads = {}
    got, want, port = _both(wide, reqs, dict(max_tokens=100),
                            each_tick=lambda p: pads.setdefault("h", list(p._slot_pad)))
    _assert_tokens_equal(got, want, port, reqs, [_context(port, r) + _sot(port.cfg)
                                                 for r in reqs])
    assert port.kv_ctx == 128
    widths = [len(port._context_ids(Request(audio=c, initial_prompt=t)))
              for c, t in zip(clips, texts)]
    assert widths[0] == 0 and widths[-1] == 115 and 30 < widths[2] < 115
    assert pads["h"] == [116, 115 - widths[1], 115 - widths[2], 0]
    np.testing.assert_allclose([r["no_speech_prob"] for r in got],
                               [r["no_speech_prob"] for r in want], rtol=0, atol=1e-5)


@pytest.mark.parametrize("self_kv_quant", [True, False], ids=["int8_cache", "float_cache"])
def test_context_at_the_cap_writes_inside_kv_ctx(wide, self_kv_quant):
    """A context at the cap (115 tokens, kv_ctx 128) leaves a budget of 8
    tokens, as in JAX: a long prompt is not an error, every offset stays
    inside the cache after every round, and the tokens equal JAX's."""
    reqs = [dict(audio=_clips(35, (1.7,))[0], language="zh", initial_prompt=PROMPTS["cap"] * 3)]
    seen = []
    got, want, port = _both(wide, reqs, dict(max_tokens=100, self_kv_quant=self_kv_quant),
                            each_tick=lambda p: seen.append(int(p.offsets.max())))
    _assert_tokens_equal(got, want, port, reqs, [_context(port, reqs[0]) + _sot(port.cfg)])
    assert max(seen) <= port.kv_ctx and got[0]["tokens"] <= 8
    assert port._slot_limit_h.max() <= port.kv_ctx


def test_engine_initial_prompt_matches_pipeline(nano):
    """The engine's prompted decode equals the port pipeline's with the same
    initial_prompt (its right-aligned prompt of one row)."""
    jp, _, pcfg = nano
    clip = _clips(36, (0.9,))[0]
    port, _ = _engines(nano)
    fut = port.submit(Request(audio=clip, language="zh", initial_prompt="hello world"))
    _run([(port, [fut])])
    pipe = WhisperPipeline(device="cpu", params=port.model, compute_dtype="float32",
                           kv_quant=True, self_kv_quant=True, max_tokens=8, language="zh",
                           initial_prompt="hello world")
    assert _ids(fut.result(0)) == pipe.transcribe_batch([clip])[0].tokens.tolist()


def _jax_gumbel(seed: int):
    """The JAX engine's aux noise for ``seed`` as the port's ``noise`` hook
    (the key splits of ``whisper_tpu/decode.py``)."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(step, shape):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape, jnp.float32)))

    return draw


def test_ladder_retry_keeps_its_prompt(nano, monkeypatch):
    """A prompted and a plain request fail the logprob gate on their slots
    and are decoded again on the aux worker at 0.5, the prompted one with
    its context (memoized on the request), each in a micro-batch of its own
    width: with the JAX engine's Gumbel draws handed in, the retries' tokens
    equal the JAX engine's, and the context changes them."""
    real = engine_mod.greedy_decode_kv
    widths = []

    def decode(model, cross, prompt, *args, temperature=0.0, **kw):
        widths.append(prompt.shape[1])
        return real(model, cross, prompt, *args, temperature=temperature,
                    noise=_jax_gumbel(0), **kw)

    monkeypatch.setattr(engine_mod, "greedy_decode_kv", decode)
    clip = _clips(37, (1.2,))[0]
    ladder = dict(temperature_fallback=(0.5,), logprob_threshold=-1.0)
    port, jeng = _engines(nano, **ladder)
    reqs = [dict(audio=clip, language="zh", initial_prompt="hello world"),
            dict(audio=clip, language="zh")]
    got = [port.submit(Request(**r)) for r in reqs]
    want = [jeng.submit(JaxRequest(**r)) for r in reqs]
    for _ in range(40):
        if all(f.done() for f in got + want):
            break
        port._tick()
        while port.aux_round():
            pass
        jeng._tick()
        while jeng._beam_pending:
            jeng._run_beam_batch(jeng._beam_collect())
    got, want = [f.result(0) for f in got], [f.result(0) for f in want]
    assert [(r["attempts"], r["temperature"]) for r in got] == [(2, 0.5)] * 2
    assert [_ids(r) for r in got] == [_ids(r) for r in want]
    assert _ids(got[0]) != _ids(got[1])
    assert sorted(widths) == [4, 1 + 16 + 4]  # one aux batch a width


# ---------------------------------------------------------------- rounds
def test_adaptive_sync_round_sizing(nano):
    """The JAX engine's scripted scenario on both engines: rounds grow to
    2x / 4x while every active slot is far from its limit, shrink as the
    nearest completion approaches, discount the size the round in flight
    was really dispatched at, and fall back to the base size with no
    resolved offsets; the same sequence of sizes on both."""
    engines = _engines(nano, adaptive_sync=True)

    def sizes(eng):
        out = [eng._adaptive_steps()]
        for i in (0, 2):
            eng._slot_req[i] = (Request if eng is engines[0] else JaxRequest)(
                audio=np.zeros(800, np.float32))
        eng._slot_limit_h[:] = 24
        for offs, last in (([5, 0, 5, 0], 2), ([17, 0, 5, 0], 2), ([21, 0, 5, 0], 2),
                           ([-1, 0, 5, 0], 2), ([13, 0, 5, 0], 8), ([13, 0, 5, 0], 2)):
            eng._last_offs_h = np.array(offs)
            eng._last_round_steps = last
            out.append(eng._adaptive_steps())
        return out

    got, want = (sizes(e) for e in engines)
    assert got == want == [2, 8, 4, 2, 8, 2, 8]


def test_adaptive_sync_engine_matches_jax(nano):
    """adaptive_sync=True end to end (base 1, a 12-token budget, arrivals
    on different ticks): the rounds take several sizes and the tokens equal
    JAX's."""
    clips = _clips(38, (0.9, 2.2, 1.5))
    reqs = [dict(audio=c, language="zh") for c in clips]
    got, want, port = _both(nano, reqs, dict(adaptive_sync=True, steps_per_sync=1,
                                             max_tokens=12), arrivals={0: [0], 3: [1], 5: [2]})
    _assert_tokens_equal(got, want, port, reqs, [_sot(PCFG)] * 3)
    assert len(port.stats.round_sizes) >= 2 and set(port.stats.round_sizes) <= {"1", "2", "4"}
    assert port.stats.steps_total == sum(int(k) * n for k, n in port.stats.round_sizes.items())


# ---------------------------------------------------------------- encode
@pytest.mark.parametrize("chunks", [2, 5])
def test_segmented_encode_matches_monolithic(nano, chunks):
    """encode_chunks splits the admission encoder into layer groups (at
    most one a layer: 5 is cut to test-nano's 2): the cross-KV equals the
    monolithic encode's exactly, for one bucket, and the tokens equal the
    JAX engine's under the same option."""
    port, _ = _engines(nano)
    seg, _ = _engines(nano, encode_chunks=chunks)
    assert seg.encode_chunks == 2 and len(seg._encode_seg_fns) == 2
    clips = _clips(39, (0.6, 1.9, 3.0))
    reqs = [Request(audio=c) for c in clips]
    for a, b in zip(port._encode(reqs, 4), seg._encode(reqs, 4)):
        assert torch.equal(a, b)
    assert set(seg._encode_seg_est) == {4} and len(seg._encode_seg_est[4]) == 2
    reqs = [dict(audio=c, language="zh") for c in clips]
    got, want, port = _both(nano, reqs, dict(encode_chunks=chunks), arrivals={0: [0], 2: [1, 2]})
    _assert_tokens_equal(got, want, port, reqs, [_sot(PCFG)] * 3)


def test_segmented_encode_pacing(nano, monkeypatch):
    """The group times are measured once a bucket while no slot is active;
    with slots active the encode sleeps 0.9 of the group in flight's time
    before the next, and measures nothing."""
    sleeps = []
    monkeypatch.setattr(engine_mod.time, "sleep", sleeps.append)
    eng, _ = _engines(nano, encode_chunks=2)
    clip = _clips(40, (0.5,))
    eng._encode([Request(audio=clip[0])], 1)
    est = list(eng._encode_seg_est[1])
    assert sleeps == [] and all(t > 0 for t in est)
    eng.stats.active_slots = 1
    eng._encode([Request(audio=clip[0])], 1)
    # a bucket not measured yet, slots active: neither paced nor measured
    eng._encode([Request(audio=clip[0])], 2)
    assert sleeps == [pytest.approx(0.9 * est[0])] and 2 not in eng._encode_seg_est


def test_start_times_every_bucket(nano):
    """start() times the layer groups of every admission bucket while no
    slot is active, so pacing has a time for each from the first burst."""
    eng, _ = _engines(nano, encode_chunks=2)
    eng.start()
    try:
        assert sorted(eng._encode_seg_est) == list(eng.prefill_buckets) == [1, 2, 4]
        assert all(len(t) == 2 and min(t) > 0 for t in eng._encode_seg_est.values())
    finally:
        eng.stop()


def test_engine_active_slots_advance_during_admission_burst(nano):
    """While an admission burst drains one chunk a round, the active slot
    advances on every round (the JAX contract)."""
    eng, _ = _engines(nano, max_slots=8, steps_per_sync=1, max_tokens=16, admit_chunk=1)
    eng.submit(Request(audio=_clips(41, (0.8,))[0], language="zh"))
    eng._tick()
    slot0 = next(i for i, r in enumerate(eng._slot_req) if r is not None)
    for c in _clips(42, (0.3,) * 4):
        eng.submit(Request(audio=c, language="zh"))
    offsets, admitted = [int(eng.offsets[slot0])], [eng.stats.active_slots]
    for _ in range(4):
        eng._tick()
        offsets.append(int(eng.offsets[slot0]))
        admitted.append(sum(r is not None for r in eng._slot_req))
    assert admitted[:4] == [1, 2, 3, 4]
    assert all(b > a for a, b in zip(offsets, offsets[1:])), (offsets, admitted)


def test_decode_advances_during_newcomer_encode(nano):
    """After start(), admission runs on the encode thread: an active slot
    keeps stepping while a newcomer's encode is held in the middle."""
    eng, _ = _engines(nano, max_slots=2, steps_per_sync=1, max_tokens=16)
    in_encode, release = threading.Event(), threading.Event()
    calls = []
    real = eng._prepare_batch

    def slow(newcomers):
        calls.append(len(newcomers))
        if len(calls) > 1:
            in_encode.set()
            release.wait(timeout=30)
        return real(newcomers)

    eng._prepare_batch = slow
    eng.start()
    try:
        assert eng._encode_thread is not None and eng._encode_thread.is_alive()
        a = eng.submit(Request(audio=_clips(43, (0.5,))[0], language="zh"))
        deadline, slot = time.monotonic() + 60, None
        while time.monotonic() < deadline:
            if slot is None and eng.stats.active_slots:
                slot = next((i for i, r in enumerate(eng._slot_req) if r is not None), None)
            if slot is not None and int(eng.offsets[slot]) >= 7:
                break
            time.sleep(0.005)
        assert slot is not None and not a.done()
        b = eng.submit(Request(audio=_clips(44, (0.5,))[0], language="zh"))
        assert in_encode.wait(timeout=30), "the newcomer's encode never started"
        off0 = int(eng.offsets[slot])
        time.sleep(0.3)
        off1 = int(eng.offsets[slot])
        release.set()
        assert off1 > off0 or a.done(), (off0, off1)
        assert a.result(timeout=60)["success"] and b.result(timeout=60)["success"]
    finally:
        release.set()
        eng.stop()
    assert eng._encode_thread is None


def test_encode_thread_burst_equals_pipeline(nano):
    """Eight requests from client threads to a started engine (encode
    thread, decode thread), the interpreter switching threads every 10 us:
    each reply's tokens equal the port pipeline's for its clip, and the
    prepared-ahead count both threads update returns to zero."""
    eng, _ = _engines(nano, max_slots=4, steps_per_sync=2)
    clips = _clips(45, (0.4, 1.1, 2.3, 0.7, 1.9, 0.5, 2.8, 1.3))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    eng.start()
    try:
        with_results = [None] * len(clips)

        def client(i):
            with_results[i] = eng.submit(Request(audio=clips[i], language="zh")).result(60)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        eng.stop()
        sys.setswitchinterval(interval)
    pipe = WhisperPipeline(device="cpu", params=eng.model, compute_dtype="float32",
                           kv_quant=True, self_kv_quant=True, max_tokens=8, language="zh")
    want = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
    assert [_ids(r) for r in with_results] == want
    assert eng.stats.prepared_depth == 0 and eng.stats.encode_batches_total >= 2
    assert not eng._ready


# ---------------------------------------------------------------- streaming
def test_on_partial_matches_jax(nano):
    """on_partial streaming: each round's partial transcript of a streaming
    slot, from the resolved buffer, in the same sequence as the JAX
    engine's; a plain request beside it streams nothing."""
    clips = _clips(46, (1.3, 0.6))
    seen = {"port": [], "jax": []}
    port, jeng = _engines(nano, steps_per_sync=1, max_tokens=8)
    a = port.submit(Request(audio=clips[0], language="zh", on_partial=seen["port"].append))
    b = port.submit(Request(audio=clips[1], language="zh"))
    ja = jeng.submit(JaxRequest(audio=clips[0], language="zh", on_partial=seen["jax"].append))
    jb = jeng.submit(JaxRequest(audio=clips[1], language="zh"))
    _run([(port, [a, b]), (jeng, [ja, jb])])
    assert seen["port"] == seen["jax"] and len(seen["port"]) >= 3
    final = a.result(0)["text"]
    assert all(final.startswith(p) for p in seen["port"])
    assert port.stats.partials_total == len(seen["port"])


def test_dead_stream_consumer_is_dropped(nano):
    """A consumer that raises stops its stream; the request still
    resolves."""
    calls = []

    def broken(text):
        calls.append(text)
        raise BrokenPipeError("client went away")

    port, _ = _engines(nano, steps_per_sync=1)
    req = Request(audio=_clips(47, (1.0,))[0], language="zh", on_partial=broken)
    port.submit(req)
    _run([(port, [req.future])])
    assert req.future.result(0)["success"] and len(calls) == 1 and req.on_partial is None
