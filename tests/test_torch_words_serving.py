"""Word timestamps through the port's entry points against the JAX package
(CPU, test-nano, fp32, the same bridged weights, the real tokenizer):
``WhisperPipeline(word_timestamps=True)`` with and without int8 cross-KV
over a short clip and one over 30 s, the CLI's ``--word_timestamps`` (txt,
srt, json), the engine's align worker on the slot path and the aux path
(beams, and a ladder retry that must keep its words), its micro-batching,
a slot re-admitted while its alignment waits (the slots' cross-KV is
rewritten in place), a (1, 2) CPU mesh, and HTTP ``word_timestamps`` and
``format=srt``. Words (text and times) and texts must be equal; word
probabilities within PROB_TOL.
"""

import json
import threading
import time
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.formats import render_payload as jax_render_payload
from whisper_tpu.formats import write_result as jax_write_result
from whisper_tpu.models import model as jm
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import cli
from whisper_tpu_torch import pipeline as port_pipeline
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.parallel.sharding import make_mesh
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving import engine as engine_module
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
SEED = 3  # weights whose greedy decodes differ from clip to clip
PROB_TOL = 1e-4  # word probabilities: exp of mean log-probs within 1e-4
PIPE = dict(model="test-nano", compute_dtype="float32", max_tokens=8, language="en",
            word_timestamps=True)
ENGINE = dict(max_slots=4, steps_per_sync=2, max_tokens=8, kv_quant=True, self_kv_quant=True,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(SEED))


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _key(words):
    return None if words is None else [(w["word"], w["start"], w["end"]) for w in words]


def _same(got_words, want_words):
    assert _key(got_words) == _key(want_words)
    np.testing.assert_allclose([w["probability"] for w in got_words],
                               [w["probability"] for w in want_words], rtol=0, atol=PROB_TOL)


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("kv_quant", [False, True])
def test_pipeline_words_equal_jax(jax_params, kv_quant):
    """``transcribe_batch`` over a 3 s clip and a 40 s one (two windows,
    their words merged and the text spelled from them): texts and words
    equal JAX's."""
    jpipe = JaxPipeline(**PIPE, kv_quant=kv_quant)
    jpipe.params = jax_params
    tpipe = WhisperPipeline(device="cpu", params=_model(jax_params), **PIPE, kv_quant=kv_quant)
    clips = _clips(41, (3.0, 40.0))
    want, got = jpipe.transcribe_batch(clips), tpipe.transcribe_batch(clips)
    assert [r.text for r in got] == [r.text for r in want]
    for a, b in zip(got, want):
        _same(a.words, b.words)
        assert a.words and all(0 <= w["start"] <= w["end"] <= a.audio_seconds + 0.5
                               for w in a.words)


def test_pipeline_silent_rows_and_seek_path_have_no_words(jax_params):
    """A silence-gated row gets an empty list; the seek path returns no
    words, as JAX's does."""
    pipe = WhisperPipeline(device="cpu", params=_model(jax_params), **PIPE,
                           no_speech_threshold=-1.0, logprob_threshold=0.0)
    (res,) = pipe.transcribe_batch(_clips(42, (2.0,)))
    assert res.words == [] and res.text == ""
    (res,) = WhisperPipeline(device="cpu", params=_model(jax_params), **PIPE
                             ).transcribe_longform(_clips(42, (2.0,)))
    assert res.words is None


# ---------------------------------------------------------------- CLI
def _wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.mark.parametrize("fmt", ["txt", "srt", "json"])
def test_cli_word_timestamps_equal_jax(jax_params, monkeypatch, tmp_path, capsys, fmt):
    """``cli.main([... "--word_timestamps", "-f", fmt])``: the srt and json
    files equal the JAX writers' output for the JAX pipeline's result; txt
    prints the text, then one line a word."""
    path = tmp_path / "a.wav"
    _wav(path, _clips(43, (3.0,))[0])
    tree = jax.tree.map(np.asarray, jax_params)
    monkeypatch.setattr(port_pipeline, "init_params",
                        lambda cfg, seed, device: from_jax_params(tree, PCFG, device=device))
    argv = ["--wav", str(path), "--model_type", "test-nano", "--device", "cpu", "--dtype",
            "float32", "--language", "en", "--max_tokens", "8", "--word_timestamps", "-f", fmt]
    if fmt != "txt":
        argv += ["-o", str(tmp_path / "out")]
    assert cli.main(argv) == 0
    jpipe = JaxPipeline(**PIPE)
    jpipe.params = jax_params
    (want,) = jpipe.transcribe_batch([str(path)])
    if fmt == "txt":
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0] == f"{path}\t[en]\t{want.text}"
        assert lines[1:] == [f"  {w['start']:7.2f} -> {w['end']:7.2f}  {w['word']}"
                             for w in want.words]
        return
    got = (tmp_path / "out" / f"a.{fmt}").read_text(encoding="utf-8")
    import io

    buf = io.StringIO()
    jax_write_result(want, fmt, buf)
    if fmt == "json":
        got, want_json = json.loads(got), json.loads(buf.getvalue())
        _same(got.pop("words"), want_json.pop("words"))
        for timing in ("rtf", "wall_seconds"):  # the run's own clock
            got.pop(timing, None), want_json.pop(timing, None)
        assert got == want_json
    else:
        assert got == buf.getvalue() and " --> " in got


# ---------------------------------------------------------------- engine
def _engines(jax_params, **kw):
    port = ContinuousBatchingEngine(_model(jax_params),
                                    get_tokenizer(language="en", task="transcribe"),
                                    compute_dtype=torch.float32, **{**ENGINE, **kw})
    jeng = JaxEngine(jax_params, CFG, jax_tokenizer(True, language="en", task="transcribe"),
                     compute_dtype=jnp.float32, **{**ENGINE, **kw})
    return port, jeng


def _drive(pairs, timeout=90):
    """Run the slots and the aux workers of every (engine, futures) pair
    until all futures are done (the align workers are threads)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
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
        time.sleep(0.002)
    raise AssertionError("requests not done in time")


REQUESTS = [dict(clip=0), dict(clip=1), dict(clip=2, beam_size=2), dict(clip=3),
            dict(clip=4, condition_on_previous=True), dict(clip=0, word_timestamps=False)]
SECONDS = (1.5, 3.0, 2.0, 40.0, 35.0)


def test_engine_words_equal_jax(jax_params):
    """The slots' harvest (short clips), the aux worker (a beam request),
    a request over 30 s fanned out and a conditioned one: replies' texts and
    words equal the JAX engine's; a request without word_timestamps has no
    ``words``."""
    clips = _clips(44, SECONDS)
    port, jeng = _engines(jax_params)

    def reqs(cls):
        return [cls(audio=clips[r["clip"]], language="en",
                    **{"word_timestamps": True,
                       **{k: v for k, v in r.items() if k != "clip"}}) for r in REQUESTS]

    got, want = [port.submit(r) for r in reqs(Request)], [jeng.submit(r) for r in reqs(JaxRequest)]
    try:
        _drive([(port, got), (jeng, want)])
        got, want = [f.result(0) for f in got], [f.result(0) for f in want]
    finally:
        port.stop()
        jeng.stop()
    assert [r["text"] for r in got] == [r["text"] for r in want]
    for a, b in zip(got[:-1], want[:-1]):
        assert "align_error" not in a and a["words"]
        _same(a["words"], b["words"])
    assert "words" not in got[-1] and "words" not in want[-1]
    assert got[2]["beam_size"] == 2 and got[3]["windows"] == 2
    assert port.stats.align_total == jeng.stats.align_total


def test_engine_retry_keeps_its_words(jax_params):
    """A request re-decoded by the temperature ladder resolves from the aux
    worker, which aligns it too (JAX's
    test_word_timestamps_survive_temperature_retry)."""
    port, _ = _engines(jax_params, logprob_threshold=-0.0001, temperature_fallback=(0.2,))
    fut = port.submit(Request(audio=_clips(45, (2.0,))[0], language="en", word_timestamps=True))
    try:
        _drive([(port, [fut])])
    finally:
        port.stop()
    reply = fut.result(0)
    assert reply["attempts"] >= 2 and isinstance(reply["words"], list) and reply["words"]
    assert "align_error" not in reply and port.stats.retries_total >= 1


def _harvest_into_queue(eng, futs, n_jobs, timeout=60):
    deadline = time.monotonic() + timeout
    while len(eng._align_q) < n_jobs and time.monotonic() < deadline:
        eng._tick()
    assert len(eng._align_q) == n_jobs, "align jobs never queued"


def test_align_worker_micro_batches(jax_params):
    """Three queued jobs are aligned in ONE bucketed pass, and their words
    equal a solo run's (JAX's test_align_worker_micro_batches)."""
    port, _ = _engines(jax_params)
    port._align_thread = threading.Thread()  # never started: the jobs wait in the queue
    clips = _clips(46, (1.0, 1.5, 2.0))
    futs = [port.submit(Request(audio=c, language="en", word_timestamps=True)) for c in clips]
    _harvest_into_queue(port, futs, 3)
    jobs = [port._align_q.popleft() for _ in range(3)]
    port._align_batch(jobs)
    results = [f.result(0) for f in futs]
    assert port.stats.align_batches_total == 1 and port.stats.align_total == 3
    solo, _ = _engines(jax_params)
    fut = solo.submit(Request(audio=clips[0], language="en", word_timestamps=True))
    try:
        _drive([(solo, [fut])])
    finally:
        solo.stop()
    assert fut.result(0)["text"] == results[0]["text"]
    _same(fut.result(0)["words"], results[0]["words"])
    assert solo.stats.align_batches_total == 1


def test_readmitted_slot_keeps_its_own_cross_kv(jax_params, monkeypatch):
    """One slot: request A finishes and its alignment is held while the
    slot is re-admitted with clip B (its cross-KV written over A's in
    place); released, A's alignment matrix and words equal a solo run of A.
    The harvest copies the slot's cross-KV; a view would align A against
    B's audio. (The matrices are compared because the random weights'
    one-word decodes give the same word times for any audio.)"""
    passes = []
    real = engine_module.alignment_matrix

    def recorded(*args, **kw):
        out = real(*args, **kw)
        passes.append(out[0].clone())
        return out

    monkeypatch.setattr(engine_module, "alignment_matrix", recorded)
    eng, _ = _engines(jax_params, max_slots=1)
    eng._align_thread = threading.Thread()  # never started: A's job waits in the queue
    a, b = _clips(47, (2.0, 3.0))
    fa = eng.submit(Request(audio=a, language="en", word_timestamps=True))
    _harvest_into_queue(eng, [fa], 1)
    fb = eng.submit(Request(audio=b, language="en"))
    for _ in range(60):
        if fb.done():
            break
        eng._tick()
    assert fb.done() and eng.stats.encode_batches_total == 2  # B went through the slot
    eng._align_batch([eng._align_q.popleft()])
    solo, _ = _engines(jax_params, max_slots=1)
    fs = solo.submit(Request(audio=a, language="en", word_timestamps=True))
    try:
        _drive([(solo, [fs])])
    finally:
        solo.stop()
    assert fa.result(0)["words"] == fs.result(0)["words"]
    assert len(passes) == 2 and torch.equal(passes[0], passes[1])


def test_engine_words_on_a_cpu_mesh_equal_tp1(jax_params):
    """An engine split over a (1, 2) mesh of CPU ranks copies each rank's
    slot cross-KV for the align worker: its words equal the one-rank
    engine's."""
    clips = _clips(48, (1.5, 2.5))
    one, _ = _engines(jax_params)
    two = ContinuousBatchingEngine(_model(jax_params),
                                   get_tokenizer(language="en", task="transcribe"),
                                   compute_dtype=torch.float32,
                                   mesh=make_mesh(1, 2, devices=["cpu", "cpu"]), **ENGINE)
    futs = {eng: [eng.submit(Request(audio=c, language="en", word_timestamps=True))
                  for c in clips] for eng in (one, two)}
    try:
        _drive(list(futs.items()))
    finally:
        one.stop()
        two.stop()
    for f1, f2 in zip(futs[one], futs[two]):
        r1, r2 = f1.result(0), f2.result(0)
        assert r1["text"] == r2["text"] and r1["words"]
        assert _key(r1["words"]) == _key(r2["words"])
        np.testing.assert_allclose([w["probability"] for w in r2["words"]],
                                   [w["probability"] for w in r1["words"]], rtol=0,
                                   atol=PROB_TOL)


# ---------------------------------------------------------------- HTTP
def test_http_words_and_subtitles_equal_jax(jax_params):
    """``word_timestamps=1`` as a query option and ``X-Word-Timestamps``:
    the JAX engine's words for the clip; ``format=srt|vtt|tsv``: 200 and
    the JAX writer's rendering of that reply; /metrics serves the align
    counters."""
    port, jeng = _engines(jax_params)
    port.start(warm=False)
    srv = make_server(port, "127.0.0.1", 0, request_timeout_s=120)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    clip = _clips(49, (2.5,))[0]
    octet = {"Content-Type": "application/octet-stream"}

    def post(query, headers=None):
        req = urllib.request.Request(f"{url}/asr?language=en{query}", data=clip.astype("<f4")
                                     .tobytes(), headers={**octet, **(headers or {})})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()

    try:
        replies = [post("&word_timestamps=1"), post("", {"X-Word-Timestamps": "1"})]
        subs = {fmt: post(f"&format={fmt}") for fmt in ("srt", "vtt", "tsv")}
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            metrics = json.load(r)
    finally:
        srv.shutdown()
        srv.server_close()
        port.stop()
        t.join(timeout=10)
    fut = jeng.submit(JaxRequest(audio=clip, language="en", word_timestamps=True))
    try:
        _drive([(jeng, [fut])])
    finally:
        jeng.stop()
    want = fut.result(0)
    for code, body in replies:
        reply = json.loads(body)
        assert code == 200 and reply["text"] == want["text"]
        _same(reply["words"], want["words"])
    for fmt, (code, body) in subs.items():
        assert code == 200 and body == jax_render_payload(json.loads(replies[0][1]), fmt)
    assert metrics["align_total"] == 5 and metrics["align_batches_total"] >= 1
