"""Beams through the port's entry points against the JAX package (CPU,
test-nano, fp32, int8 cross- and self-KV, the same bridged weights):
``WhisperPipeline(beam_size=3)`` with the temperature ladder off and on,
the seek loop over a 45 s clip, the CLI's ``--beam``, the engine's aux
worker (short, over-30 s and conditioned requests, two beam sizes), HTTP
``beam`` and a (1, 2) CPU mesh.

The weights lean towards eot as in ``tests/test_torch_beam.py``, so
hypotheses finish at differing lengths. Tokens and texts must be equal.
"""

import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.pipeline
from test_torch_beam import eot_leaning
from test_torch_ladder import _CopyingNumpy, jax_gumbel
from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch import cli
from whisper_tpu_torch import pipeline as port_pipeline
from whisper_tpu_torch.beam import BeamResult
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import GreedyResult
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.parallel.sharding import make_mesh
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
MAX_TOKENS = 10
PIPE = dict(compute_dtype="float32", max_tokens=MAX_TOKENS, kv_quant=True, self_kv_quant=True,
            language="zh", beam_size=3)
ENGINE = dict(max_slots=4, steps_per_sync=2, max_tokens=MAX_TOKENS, kv_quant=True,
              self_kv_quant=True, no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)


class IdTok:
    """Decodes to the ids themselves; encodes prompts and suppresses
    non-speech as the real tokenizer does."""

    def __init__(self):
        tok = get_tokenizer(num_languages=PCFG.num_languages)
        self.non_speech_tokens = tok.non_speech_tokens
        self.encode = tok.encode

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode


@pytest.fixture(scope="module")
def weights():
    return eot_leaning(jm.init_params(CFG, jax.random.PRNGKey(0)))


def _tree(jp):
    return jax.tree.map(np.asarray, jp)


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _pipelines(weights, **kw):
    """(JAX pipeline, port pipeline) on the leaning weights."""
    jpipe = JaxPipeline(model="test-nano", **{**PIPE, **kw})
    jpipe.params = weights[0]
    tpipe = WhisperPipeline(device="cpu", params=from_jax_params(_tree(weights[0]), PCFG,
                                                                 device="cpu"),
                            **{**PIPE, **kw})
    return jpipe, tpipe


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("ladder", [False, True])
def test_pipeline_beam_equals_jax(weights, monkeypatch, ladder):
    """``transcribe_batch`` at beam 3 (a 35 s clip split into two windows
    among them): texts and tokens equal JAX's. With the ladder every row
    fails the logprob gate and is re-decoded by sampling, one beam a row,
    at each rung, with JAX's draws handed to the port."""
    jpipe, tpipe = _pipelines(weights, temperature_fallback=ladder)
    if ladder:
        monkeypatch.setattr(whisper_tpu.pipeline, "np", _CopyingNumpy())
        real = port_pipeline.greedy_decode_kv
        calls = []

        def decode(*args, temperature=0.0, seed=0, **kw):
            calls.append(temperature)
            return real(*args, temperature=temperature, seed=seed, noise=jax_gumbel(seed), **kw)

        monkeypatch.setattr(port_pipeline, "greedy_decode_kv", decode)
    clips = _clips(21, (2.0, 5.0, 35.0))
    want = jpipe.transcribe_batch(clips)
    got = tpipe.transcribe_batch(clips)
    assert [r.text for r in got] == [r.text for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.no_speech_prob == pytest.approx(b.no_speech_prob, rel=1e-4, abs=1e-6)
    if ladder:
        assert calls == [0.2, 0.4, 0.6, 0.8, 1.0]
        assert isinstance(tpipe.last_decode, GreedyResult)
    else:
        assert isinstance(tpipe.last_decode, BeamResult)
        # a hypothesis finished (eot) before the cap
        assert (tpipe.last_decode.lengths < 4 + MAX_TOKENS).any()


def test_seek_loop_beam_equals_jax(weights):
    """``transcribe_longform`` (the seek loop, timestamps, conditioned on
    the previous text) at beam 3 over a 45 s and a 4 s clip: segments and
    texts equal JAX's."""
    jpipe, tpipe = _pipelines(weights, language="en")
    clips = _clips(22, (45.0, 4.0))
    want = jpipe.transcribe_longform(clips)
    got = tpipe.transcribe_longform(clips)
    assert [(r.text, r.segments) for r in got] == [(r.text, r.segments) for r in want]
    assert tpipe.last_seek["rounds"] >= 2


def test_cli_beam_equals_jax(weights, monkeypatch, tmp_path, capsys):
    """``cli.main([... "--beam", "3"])`` on a WAV prints JAX's text for it
    (the pipeline's random init swapped for the bridged weights)."""
    import wave

    clip = _clips(23, (3.0,))[0]
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(clip, -1, 1) * 32767).astype("<i2").tobytes())
    tree = _tree(weights[0])
    monkeypatch.setattr(port_pipeline, "init_params",
                        lambda cfg, seed, device: from_jax_params(tree, PCFG, device=device))
    report = {}
    argv = ["--wav", str(path), "--model_type", "test-nano", "--device", "cpu", "--dtype",
            "float32", "--language", "zh", "--max_tokens", str(MAX_TOKENS), "--kv_quant",
            "--self_kv_quant", "--beam", "3"]
    assert cli.main(argv, report=report) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert isinstance(report["pipeline"].last_decode, BeamResult)
    jpipe, _ = _pipelines(weights)
    assert line == f"{path}\t[zh]\t{jpipe.transcribe_batch([str(path)])[0].text}"


# ---------------------------------------------------------------- engine
def _engines(weights, **kw):
    model = from_jax_params(_tree(weights[0]), PCFG, device="cpu")
    port = ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32,
                                    **{**ENGINE, **kw})
    jeng = JaxEngine(weights[0], CFG, IdTok(), compute_dtype=jnp.float32, **{**ENGINE, **kw})
    return port, jeng


def _drive(pairs, limit=60):
    """Run the slots and the aux workers of every (engine, futures) pair
    until all futures are done: the port's ``aux_round``, the JAX engine's
    ``_run_beam_batch(_beam_collect())``."""
    for _ in range(limit):
        if all(f.done() for _, futs in pairs for f in futs):
            return
        for eng, _ in pairs:
            eng._tick()
            if isinstance(eng, ContinuousBatchingEngine):
                while eng.aux_round():
                    pass
            else:
                while eng._beam_pending:
                    eng._run_beam_batch(eng._beam_collect())
    raise AssertionError(f"requests not done after {limit} rounds")


REQUESTS = [  # Request keywords, the audio by clip index
    dict(clip=0, beam_size=3),
    dict(clip=1, beam_size=3),
    dict(clip=2, beam_size=2),
    dict(clip=3, beam_size=3),                                   # 40 s: two windows
    dict(clip=4, beam_size=3, condition_on_previous=True),        # 65 s, window by window
    dict(clip=1, beam_size=3, initial_prompt="hello there"),
    dict(clip=0),                                                 # greedy, on the slots
]
SECONDS = (1.5, 4.0, 2.5, 40.0, 65.0)


def _requests(cls, clips):
    return [cls(audio=clips[r["clip"]], language="zh",
                **{k: v for k, v in r.items() if k != "clip"}) for r in REQUESTS]


def test_engine_aux_beams_equal_jax(weights):
    """The aux worker's beam micro-batches (keyed by beam size and context
    width; windows of the long requests among them) answer as the JAX
    engine's beam worker: the same ids, windows, beam sizes and counts."""
    clips = _clips(24, SECONDS)
    port, jeng = _engines(weights)
    got = [port.submit(r) for r in _requests(Request, clips)]
    want = [jeng.submit(r) for r in _requests(JaxRequest, clips)]
    _drive([(port, got), (jeng, want)])
    got, want = [f.result(0) for f in got], [f.result(0) for f in want]
    keys = ("text", "tokens", "language", "windows", "beam_size", "temperature")
    assert [{k: r.get(k) for k in keys} for r in got] == [{k: r.get(k) for k in keys}
                                                          for r in want]
    np.testing.assert_allclose([r["avg_logprob"] for r in got],
                               [r["avg_logprob"] for r in want], rtol=1e-4, atol=1e-5)
    assert [r.get("beam_size") for r in got] == [3, 3, 2, None, None, 3, None]
    # the 4 short beam requests and the 2 + 3 windows of the long ones
    assert port.stats.beam_requests_total == jeng.stats.beam_requests_total == 9
    assert port.stats.aux_batches_total >= 4


def test_engine_beam_retry_samples_one_beam(weights):
    """With the ladder on, a beam result that fails the logprob gate is
    decoded again on the aux worker by sampling (one beam), as the JAX
    engine does: attempts, temperature and beam_size of the reply."""
    clip = _clips(25, (2.0,))[0]
    port, _ = _engines(weights, temperature_fallback=(0.5,), logprob_threshold=-1.0)
    fut = port.submit(Request(audio=clip, language="zh", beam_size=3))
    _drive([(port, [fut])])
    reply = fut.result(0)
    assert (reply["attempts"], reply["temperature"], reply["beam_size"]) == (2, 0.5, 1)
    assert port.stats.retries_total == 1 and port.stats.beam_requests_total == 0


def test_engine_refuses_a_beam_above_the_cap(weights):
    port, _ = _engines(weights, max_beam_size=4)
    with pytest.raises(ValueError, match="exceeds the engine cap 4"):
        port.submit(Request(audio=np.zeros(1600, np.float32), beam_size=5))
    assert port.transcribe_beam is not None


def test_beams_on_a_cpu_mesh_equal_tp1(weights):
    """Beams through an engine split over a (1, 2) mesh of CPU ranks (each
    rank folds its local heads) answer as the one-rank engine."""
    clips = _clips(26, SECONDS)
    model = from_jax_params(_tree(weights[0]), PCFG, device="cpu")
    one, _ = _engines(weights)
    two = ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32,
                                   mesh=make_mesh(1, 2, devices=["cpu", "cpu"]), **ENGINE)
    reqs = [dict(clip=0, beam_size=3), dict(clip=2, beam_size=2), dict(clip=3, beam_size=3)]
    futs = {eng: [eng.submit(Request(audio=clips[r["clip"]], language="zh",
                                     beam_size=r["beam_size"])) for r in reqs]
            for eng in (one, two)}
    _drive(list(futs.items()))
    got = [[f.result(0)["text"] for f in futs[eng]] for eng in (one, two)]
    assert got[0] == got[1] and all(got[0])


# ---------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def server(weights):
    model = from_jax_params(_tree(weights[0]), PCFG, device="cpu")
    eng = ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32,
                                   **ENGINE).start(warm=False)
    srv = make_server(eng, "127.0.0.1", 0, request_timeout_s=120)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", eng
    srv.shutdown()
    srv.server_close()
    eng.stop()
    t.join(timeout=10)


def _wav(x: np.ndarray) -> bytes:
    import struct

    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def _post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            import json

            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_http_beam_by_query_multipart_and_header(weights, server):
    """``beam=3`` as a query option, a multipart field and ``X-Beam``: each
    reply carries ``beam_size`` 3 and the JAX engine's text for the clip
    (its WAV rounding included); ``beam=9`` is a 400 at the default
    ``max_beam_size`` of 8."""
    url, eng = server
    clip = np.round(_clips(27, (2.5,))[0] * 32767) / 32767  # as the WAV field reads back
    clip = clip.astype(np.float32)
    pcm, octet = clip.astype("<f4").tobytes(), {"Content-Type": "application/octet-stream"}
    form = (b"--B\r\nContent-Disposition: form-data; name=\"wav\"; filename=\"a.wav\"\r\n\r\n"
            + _wav(clip) + b"\r\n--B\r\nContent-Disposition: form-data; name=\"beam\"\r\n\r\n3"
            + b"\r\n--B--\r\n")
    before = eng.stats.beam_requests_total
    replies = [_post(f"{url}/asr?beam=3", pcm, octet),
               _post(f"{url}/asr", form, {"Content-Type": "multipart/form-data; boundary=B"}),
               _post(f"{url}/asr", pcm, {**octet, "X-Beam": "3"})]
    assert [(code, r["beam_size"]) for code, r in replies] == [(200, 3)] * 3
    _, jeng = _engines(weights)
    want = jeng.submit(JaxRequest(audio=clip, language="zh", beam_size=3))
    _drive([(jeng, [want])])
    assert [r["text"] for _, r in replies] == [want.result(0)["text"]] * 3
    assert eng.stats.beam_requests_total - before == 3
    code, err = _post(f"{url}/asr?beam=9", pcm, octet)
    assert code == 400 and "1..8" in err
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        assert b"beam_requests_total" in r.read()

