"""Temperature sampling and OpenAI's temperature-fallback ladder in the port,
against the JAX package (fp32, test-nano, same bridged weights).

The JAX sampler draws ``jax.random.categorical`` = argmax(logits + Gumbel
noise) from ``PRNGKey(seed)`` and its splits; the tests hand the same draws
to the port's ``noise`` hook (:func:`jax_gumbel`), so sampled tokens must be
equal. With random weights every decode fails the logprob gate, so a ladder
climbs all its rungs: the pipeline's final tokens are the 1.0 rung's draws,
and every engine request takes six attempts.
"""

import argparse
import json
import os
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import pipeline as port_pipeline
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import encode_cross_kv, greedy_decode_kv
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
MAX_TOKENS = 8
LADDER = (0.2, 0.4, 0.6, 0.8, 1.0)


def jax_gumbel(seed: int):
    """The JAX sampler's noise as the port's ``noise`` hook: the key
    sequence of ``whisper_tpu/decode.py`` (``key, sub = split(key)`` before
    the first token and at every loop step), then ``jax.random.gumbel(sub)``
    of the logits' shape, as ``jax.random.categorical`` draws it."""
    state = {"key": jax.random.PRNGKey(seed)}

    def draw(step, shape):
        state["key"], sub = jax.random.split(state["key"])
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape, jnp.float32)))

    return draw


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(0))


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


@pytest.mark.parametrize("temperature", [0.2, 0.6, 1.0])
def test_sampled_decode_equals_jax(jax_params, temperature):
    """fp32, rules on: with JAX's Gumbel draws handed in, the port samples
    JAX's tokens, and its average logprob (of the unscaled distribution)
    agrees to 1e-5."""
    model = _model(jax_params)
    mel = np.random.default_rng(3).standard_normal(
        (3, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int64), (3, 1))
    suppress = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
    seed = int(temperature * 1000)
    ref = jax_greedy_decode_kv(
        jax_params, jax_encode_cross_kv(jax_params, jnp.asarray(mel), CFG),
        jnp.asarray(prompt, jnp.int32), CFG, max_tokens=MAX_TOKENS,
        suppress_ids=jnp.asarray(suppress), apply_filters=True,
        temperature=temperature, seed=seed)
    cross = encode_cross_kv(model, torch.from_numpy(mel))
    kw = dict(max_tokens=MAX_TOKENS, suppress_ids=torch.as_tensor(suppress, dtype=torch.int64),
              apply_filters=True)
    got = greedy_decode_kv(model, cross, torch.from_numpy(prompt), temperature=temperature,
                           seed=seed, noise=jax_gumbel(seed), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(ref.avg_logprob),
                               rtol=0, atol=1e-5)
    greedy = greedy_decode_kv(model, cross, torch.from_numpy(prompt), **kw)
    assert not torch.equal(got.tokens, greedy.tokens), "the draws changed no token"


def test_own_noise_is_seeded(jax_params):
    """Without the hook the port draws its own noise from ``seed``: the same
    seed gives the same tokens, another seed others."""
    model = _model(jax_params)
    mel = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32))
    cross = encode_cross_kv(model, mel)
    prompt = torch.tensor([CFG.sot_sequence("zh")] * 2)

    def run(seed):
        return greedy_decode_kv(model, cross, prompt, max_tokens=MAX_TOKENS, temperature=1.0,
                                seed=seed).tokens

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))


class _CopyingNumpy:
    """numpy whose ``asarray`` returns a writable copy. The JAX pipeline's
    ``_temperature_retry`` writes the retried rows into
    ``np.asarray(result.tokens)``, which this JAX version returns
    read-only (a ValueError); its ladder runs on such copies here."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return np.array(a, *args, **kw)


def _with_jax_noise(monkeypatch, calls):
    """Route the pipeline's sampled decodes through JAX's draws for their
    seed, counting them in ``calls``."""
    real = port_pipeline.greedy_decode_kv

    def decode(*args, temperature=0.0, seed=0, **kw):
        if temperature > 0:
            calls.append((temperature, seed))
            kw["noise"] = jax_gumbel(seed)
        return real(*args, temperature=temperature, seed=seed, **kw)

    monkeypatch.setattr(port_pipeline, "greedy_decode_kv", decode)


@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_pipeline_ladder_equals_jax(monkeypatch, temperature):
    """``transcribe_batch`` with the ladder on (and a sampled first decode at
    0.4): every row fails the logprob gate, climbs each rung above the
    first temperature with seed int(t * 1000), and ends with JAX's tokens
    and texts."""
    kw = dict(compute_dtype="float32", max_tokens=MAX_TOKENS, kv_quant=True, self_kv_quant=True,
              language="zh", temperature=temperature, temperature_fallback=True)
    jpipe = JaxPipeline(model="test-nano", **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jpipe.params), PCFG, device="cpu")
    tpipe = WhisperPipeline(device="cpu", params=params, **kw)
    import whisper_tpu.pipeline

    monkeypatch.setattr(whisper_tpu.pipeline, "np", _CopyingNumpy())
    calls = []
    _with_jax_noise(monkeypatch, calls)
    clips = _clips(12, (2.0, 5.0, 1.0))
    ref = jpipe.transcribe_batch(clips)
    got = tpipe.transcribe_batch(clips)
    rungs = [t for t in LADDER if t > temperature]
    assert calls == [(temperature, 0)] * (temperature > 0) + [(t, int(t * 1000)) for t in rungs]
    assert [r.text for r in got] == [r.text for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_pipeline_ladder_off_by_default():
    """No checkpoint can be given yet, so the ladder is off unless asked
    for, as in the JAX pipeline with random weights."""
    assert not WhisperPipeline(model="test-nano", device="cpu").temperature_fallback
    assert not JaxPipeline(model="test-nano").temperature_fallback


def test_seek_loop_with_ladder_equals_jax(monkeypatch):
    """The JAX seek loop decodes greedily and never runs the ladder; the
    port's does the same, with the ladder on: segments and texts equal JAX's
    and no sampled decode runs."""
    kw = dict(compute_dtype="float32", max_tokens=MAX_TOKENS, language="en",
              temperature_fallback=True, condition_on_previous_text=False)
    jpipe = JaxPipeline(model="test-nano", **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jpipe.params), PCFG, device="cpu")
    tpipe = WhisperPipeline(device="cpu", params=params, **kw)
    calls = []
    _with_jax_noise(monkeypatch, calls)
    clips = _clips(13, (40.0, 3.0))
    ref = jpipe.transcribe_longform(clips)
    got = tpipe.transcribe_longform(clips)
    assert calls == []
    assert [(r.text, r.segments) for r in got] == [(r.text, r.segments) for r in ref]


class IdTok:
    """Decodes to the ids themselves; the suppressed set is the real one."""

    def __init__(self):
        self.non_speech_tokens = get_tokenizer(num_languages=PCFG.num_languages).non_speech_tokens

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


ENGINE = dict(max_slots=4, steps_per_sync=2, max_tokens=MAX_TOKENS, kv_quant=True,
              self_kv_quant=True, temperature_fallback=LADDER)


def _port_engine(jax_params, **kw):
    return ContinuousBatchingEngine(_model(jax_params), IdTok(), compute_dtype=torch.float32,
                                    **{**ENGINE, **kw})


def test_engine_ladder_equals_jax(jax_params):
    """Three greedy requests and one sampled at 0.4 to an engine with the
    ladder (0.4, 1.0) (two rungs: each rung's temperature is one more JAX
    compile): each request's attempts, final temperature and gates, and the
    retry count, equal the JAX engine's; the sampled request skips the 0.4
    rung. Slot rounds (``_tick``) and aux rounds are driven by hand on
    both."""
    clips = _clips(14, (0.6, 2.5, 1.2, 1.8))
    temps = (0.0, 0.0, 0.0, 0.4)
    ladder = dict(ENGINE, temperature_fallback=(0.4, 1.0))
    port = _port_engine(jax_params, **ladder)
    jeng = JaxEngine(jax_params, CFG, IdTok(), compute_dtype=jnp.float32, **ladder)
    got = [port.submit(Request(audio=c, language="zh", temperature=t))
           for c, t in zip(clips, temps)]
    want = [jeng.submit(JaxRequest(audio=c, language="zh", temperature=t))
            for c, t in zip(clips, temps)]
    for _ in range(60):
        if all(f.done() for f in got + want):
            break
        port._tick()
        port.aux_round()
        jeng._tick()
        while jeng._beam_pending:
            jeng._run_beam_batch(jeng._beam_collect())
    keys = ("attempts", "temperature", "quality_ok", "success")
    got = [{k: f.result(0)[k] for k in keys} for f in got]
    want = [{k: f.result(0)[k] for k in keys} for f in want]
    assert got == want
    assert [(r["attempts"], r["temperature"]) for r in got] == [(3, 1.0)] * 4
    assert port.stats.retries_total == jeng.stats.retries_total == 3 * 2 + 1
    assert port.stats.requests_total == 4 and port.stats.aux_batches_total >= 2


def test_engine_ladder_off_resolves_once(jax_params):
    """Without a ladder a failing greedy request resolves from its slot, at
    attempt 1, and a sampled request from one aux round."""
    port = _port_engine(jax_params, temperature_fallback=())
    a, b = (port.submit(Request(audio=c, temperature=t))
            for c, t in zip(_clips(15, (0.8, 0.8)), (0.0, 0.7)))
    for _ in range(30):
        if a.done() and b.done():
            break
        port._tick()
        port.aux_round()
    ra, rb = a.result(0), b.result(0)
    assert (ra["attempts"], ra["temperature"], ra["quality_ok"]) == (1, 0.0, False)
    assert (rb["attempts"], rb["temperature"]) == (1, 0.7)
    assert port.stats.retries_total == 0 and port.stats.aux_batches_total == 1


def test_engine_counters_hold_under_concurrent_threads(jax_params):
    """The decode thread and the aux worker both gate, count and resolve
    requests: more threads than cores, switching every microsecond, lose no
    update of the shared counters."""
    port = _port_engine(jax_params)
    n_threads, n_iter = (os.cpu_count() or 1) + 4, 200
    audio = np.zeros(16000, np.float32)

    def work():
        for _ in range(n_iter):
            text, comp, ok, _ = port._quality_gate("a b", 0.0, -5.0)
            port._resolve(Request(audio=audio), text, 2, 0.0, -5.0, comp, ok)
            port._add_busy(1.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * n_iter
    st = port.stats
    assert (st.requests_total, st.low_quality_total, st.tokens_total) == (n, n, 2 * n)
    assert (st.audio_seconds_total, st.busy_seconds_total) == (float(n), float(n))


def test_server_default_ladder_equals_jax(monkeypatch):
    """The port server's zero-flag ladder is the JAX server's, and reaches
    the engine as the same tuple."""
    import whisper_tpu.serving.__main__ as jax_main

    seen = {}
    real = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["args"] = real(self, args, namespace)
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed):
        jax_main.main([])
    monkeypatch.undo()
    port = parse_args([])
    assert port.temperature_fallback == seen["args"].temperature_fallback == "0.2,0.4,0.6,0.8,1.0"
    engine, _ = build_engine(parse_args(["--model_type", "test-nano", "--device", "cpu",
                                         "--dtype", "float32", "--no-w8a8"]))
    assert engine.temperature_fallback == LADDER
    off, _ = build_engine(parse_args(["--model_type", "test-nano", "--device", "cpu",
                                      "--dtype", "float32", "--no-w8a8",
                                      "--temperature_fallback", ""]))
    assert off.temperature_fallback == ()


def test_http_temperature_request_answers_200(jax_params):
    """``temperature`` is served over HTTP: a started engine (aux thread on)
    answers a sampled request with 200, at its temperature."""
    eng = _port_engine(jax_params, temperature_fallback=()).start()
    srv = make_server(eng, "127.0.0.1", 0, request_timeout_s=60)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        pcm = _clips(16, (0.5,))[0].astype("<f4").tobytes()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/asr", data=pcm,
            headers={"Content-Type": "application/octet-stream", "X-Temperature": "0.5"})
        with urllib.request.urlopen(req, timeout=60) as r:
            code, res = r.status, json.load(r)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/metrics",
                                    timeout=10) as r:
            metrics = json.load(r)
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()
        t.join(timeout=10)
    assert code == 200 and res["success"] and res["temperature"] == 0.5
    assert res["attempts"] == 1 and "retries_total" in metrics
    assert eng._aux_thread is None and not t.is_alive()
