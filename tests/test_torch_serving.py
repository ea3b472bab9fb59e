"""The port's serving path: engine, HTTP front end, client and entry point
(CPU, test-nano, fp32).

The engine's tokens are held against the JAX ContinuousBatchingEngine and
against the port's own offline pipeline; rounds are driven with ``_tick()``
so admissions land on chosen ticks. Threaded and HTTP tests bind port 0 and
wait with timeouts.
"""

import json
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.models.model import KVCache, decoder_forward
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving import client
from whisper_tpu_torch.serving.__main__ import main as serve_main
from whisper_tpu_torch.serving.engine import (
    ContinuousBatchingEngine,
    OverloadedError,
    Request,
)
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")


class IdTok:
    """Decodes to the ids themselves, so a reply carries its tokens; the
    suppressed non-speech set is the real tokenizer's."""

    eot = PCFG.eot

    def __init__(self):
        self.non_speech_tokens = get_tokenizer(num_languages=PCFG.num_languages).non_speech_tokens

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def split_to_word_tokens(self, ids):
        """One word a token, for word timings."""
        return [f" {int(i)}" for i in ids], [[int(i)] for i in ids]


def _ids(res: dict):
    return [int(t) for t in res["text"].split()]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(0))


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")


def _engine(jax_params, **kw):
    opts = dict(max_slots=4, compute_dtype=torch.float32, steps_per_sync=2, max_tokens=8,
                kv_quant=True, self_kv_quant=True, no_speech_threshold=None,
                logprob_threshold=None, compression_ratio_threshold=None)
    opts.update(kw)
    return ContinuousBatchingEngine(_model(jax_params), IdTok(), **opts)


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _run_ticks(engine, futs, limit=60):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        engine._tick()
    raise AssertionError(f"requests not done after {limit} ticks")


def _margin(model, clip, prefix):
    """The port's top-2 logit margin after ``prefix``, teacher-forced on
    ``clip`` (fp32 cross-KV): how near a tie the step was."""
    from whisper_tpu_torch.decode import encode_cross_kv
    from whisper_tpu_torch.ops.mel import log_mel_batch

    audio = np.zeros((1, 480000), np.float32)
    audio[0, : len(clip)] = clip
    mel = log_mel_batch(torch.from_numpy(audio), torch.tensor([len(clip)]),
                        n_mels=PCFG.n_mels)[..., : 2 * PCFG.n_audio_ctx]
    cross = encode_cross_kv(model, mel)
    logits, _ = decoder_forward(model, torch.tensor([prefix]), 0,
                                KVCache.create(PCFG, 1, device="cpu"), cross)
    top2 = torch.topk(logits[0, -1], 2).values
    return float(top2[0] - top2[1])


def test_engine_tokens_equal_jax_engine_and_pipeline(jax_params):
    """fp32, int8 cross- and self-KV, 4 clips of different lengths admitted
    over different ticks into 4 slots: the port engine gives the JAX
    engine's tokens and the port pipeline's."""
    clips = _clips(21, (0.6, 2.5, 1.2, 4.0))
    port = _engine(jax_params)
    jeng = JaxEngine(jax_params, CFG, IdTok(), max_slots=4, compute_dtype=jnp.float32,
                     steps_per_sync=2, max_tokens=8, kv_quant=True, self_kv_quant=True,
                     no_speech_threshold=None, logprob_threshold=None,
                     compression_ratio_threshold=None)
    arrivals = {0: [0, 1], 2: [2], 3: [3]}  # tick -> clips submitted before it
    got, want = [None] * 4, [None] * 4
    for tick in range(40):
        for i in arrivals.get(tick, []):
            got[i] = port.submit(Request(audio=clips[i], language="zh"))
            want[i] = jeng.submit(JaxRequest(audio=clips[i], language="zh"))
        port._tick()
        jeng._tick()
        if tick > 3 and all(f.done() for f in got + want):
            break
    got = [_ids(f.result(0)) for f in got]
    want = [_ids(f.result(0)) for f in want]
    pipe = WhisperPipeline(device="cpu", params=_model(jax_params), compute_dtype="float32",
                           kv_quant=True, self_kv_quant=True, max_tokens=8, language="zh")
    offline = [r.tokens.tolist() for r in pipe.transcribe_batch(clips)]
    for name, ref in (("JAX engine", want), ("port pipeline", offline)):
        for i, (g, w) in enumerate(zip(got, ref)):
            if g != w:
                t = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
                prefix = list(CFG.sot_sequence("zh")) + w[:t]
                pytest.fail(f"clip {i} differs from the {name} at token {t} (port {g[t:t + 1]}, "
                            f"{name} {w[t:t + 1]}), top-2 margin "
                            f"{_margin(pipe.model, clips[i], prefix):.3g}")
    assert port.stats.requests_total == 4 and port.stats.ticks_total >= 4
    assert port.stats.steps_total % 2 == 0 and port.stats.steps_total > 0


def test_engine_backpressure(jax_params):
    eng = _engine(jax_params, max_queue=2)  # not started: the queue only fills
    clip = _clips(1, (0.2,))[0]
    eng.submit(Request(audio=clip))
    eng.submit(Request(audio=clip))
    with pytest.raises(OverloadedError):
        eng.submit(Request(audio=clip))


def test_engine_deadlines_and_cancellation(jax_params):
    """One slot. A deadline passes in the queue; another mid-decode (the
    slot frees); a queued and an in-flight request are cancelled; the slot
    then serves a fresh request."""
    eng = _engine(jax_params, max_slots=1)
    a, b, c = _clips(2, (1.0, 0.3, 0.5))
    long_req = Request(audio=a, deadline_s=1000.0)
    eng.submit(long_req)
    eng._tick()  # long_req admitted
    doomed = Request(audio=b, deadline_s=1e-4)
    eng.submit(doomed)
    long_req.deadline_s = 0.0  # now past it, mid-decode
    time.sleep(0.01)
    eng._tick()
    with pytest.raises(TimeoutError, match="in queue"):
        doomed.future.result(0)
    with pytest.raises(TimeoutError, match="mid-decode"):
        long_req.future.result(0)
    assert eng.stats.active_slots == 0

    queued = Request(audio=b)
    eng.submit(queued)
    assert queued.cancel()
    inflight = Request(audio=a)
    eng.submit(inflight)
    eng._tick()
    assert eng._slot_req[0] is inflight and queued.future.cancelled()
    assert inflight.cancel()
    fresh = Request(audio=c)
    eng.submit(fresh)
    _run_ticks(eng, [fresh.future])
    assert fresh.future.result(0)["success"] and eng._slot_req[0] is None


def test_harvest_slot_reuse_no_cross_wiring(jax_params):
    """A slot harvested and re-admitted in one tick leaves the previous
    request's done row in the buffer packed that tick; resolving it next
    tick must not deliver it to the new occupant (the _slot_gen guard)."""
    eng = _engine(jax_params, max_slots=1, steps_per_sync=4, max_tokens=2)
    wav_a, wav_b = _clips(3, (0.5, 0.9))
    fa = eng.submit(Request(audio=wav_a))
    eng._tick()                      # A admitted into slot 0
    eng._tick()                      # round: A reaches its 2-token limit
    fb = eng.submit(Request(audio=wav_b))
    eng._tick()                      # packs A's stale done row, resolves A,
    #                                  frees slot 0 and re-admits B into it
    assert fa.done() and int(eng._slot_gen[0]) == 2
    eng._tick()                      # resolves the stale pre-admit buffer
    assert not fb.done(), "a stale harvest buffer resolved the re-admitted slot's request"
    _run_ticks(eng, [fb])
    pipe = WhisperPipeline(device="cpu", params=_model(jax_params), compute_dtype="float32",
                           kv_quant=True, self_kv_quant=True, max_tokens=2, language="zh")
    ref = [r.tokens.tolist() for r in pipe.transcribe_batch([wav_a, wav_b])]
    assert [_ids(fa.result(0)), _ids(fb.result(0))] == ref
    assert fb.result(0)["audio_seconds"] == pytest.approx(0.9)


def test_engine_per_request_max_tokens(jax_params):
    eng = _engine(jax_params, max_tokens=12)
    clip = _clips(4, (1.0,))[0]
    short, default = Request(audio=clip, max_tokens=3), Request(audio=clip)
    eng.submit(short)
    eng.submit(default)
    _run_ticks(eng, [short.future, default.future])
    a, b = short.future.result(0), default.future.result(0)
    assert a["tokens"] <= 3 and b["tokens"] <= 12
    assert _ids(a) == _ids(b)[:3]  # the same clip: the short one is a prefix


# request options the engine refused until they were ported; each is served
# now (word timings against the JAX engine in test_torch_words_serving.py)
FORMERLY_REFUSED_REQUESTS = {
    "word_timestamps": dict(word_timestamps=True),
}


@pytest.mark.parametrize("option", list(FORMERLY_REFUSED_REQUESTS))
def test_engine_refuses_unported_request_options(jax_params, option):
    """No request option is refused as not ported any more: the option is
    accepted and its reply carries what it asks for (``words``)."""
    eng = _engine(jax_params)
    kw = {"audio": _clips(4, (1.0,))[0], **FORMERLY_REFUSED_REQUESTS[option]}
    fut = eng.submit(Request(**kw))
    deadline = time.monotonic() + 60
    while not fut.done() and time.monotonic() < deadline:  # the align worker is a thread
        eng._tick()
        time.sleep(0.005)
    reply = fut.result(timeout=0)
    assert isinstance(reply["words"], list) and "align_error" not in reply
    eng.stop()


def test_engine_serves_a_beam_submit(jax_params):
    """A beam request is served by the aux worker (its tokens against the
    JAX engine's in test_torch_beam_serving.py); above max_beam_size it is
    a ValueError."""
    eng = _engine(jax_params, max_beam_size=4)
    fut = eng.submit(Request(audio=_clips(5, (1.0,))[0], beam_size=2))
    assert eng.aux_round() == 1
    reply = fut.result(0)
    assert reply["success"] and reply["beam_size"] == 2
    assert eng.stats.beam_requests_total == 1 and eng.stats.aux_batches_total == 1
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(Request(audio=np.zeros(1600, np.float32), beam_size=5))


# ---------------------------------------------------------------- HTTP
def _wav_bytes(x: np.ndarray) -> bytes:
    """16-bit PCM WAV of ``x`` (|x| < 1), which reads back as
    round(x * 32768) / 32768."""
    pcm = np.round(x * 32768).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


@pytest.fixture(scope="module")
def http_server(jax_params):
    eng = _engine(jax_params, max_slots=4, steps_per_sync=4).start(warm=False)
    srv = make_server(eng, "127.0.0.1", 0, request_timeout_s=60)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    eng.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url, data, headers, timeout=60):
    with urllib.request.urlopen(urllib.request.Request(url, data=data, headers=headers),
                                timeout=timeout) as r:
        return r.status, json.load(r)


def _post_error(url, data, headers):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, data, headers)
    return ei.value.code, json.load(ei.value)


def test_http_health_metrics_options(http_server):
    with urllib.request.urlopen(f"{http_server}/health", timeout=10) as r:
        assert json.load(r)["status"] == "healthy"
    with urllib.request.urlopen(f"{http_server}/metrics", timeout=10) as r:
        m = json.load(r)
    assert "requests_total" in m and "rtf" in m and "steps_total" in m
    req = urllib.request.Request(f"{http_server}/asr", method="OPTIONS")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.headers["Access-Control-Allow-Origin"] == "*"


def test_http_asr_octet_multipart_and_wav(http_server):
    """The C++ protocol (f32 PCM), the Python one (multipart WAV) and a bare
    WAV body all transcribe; the same 16-bit clip gives the same text."""
    clip = (np.round(_clips(5, (0.6,))[0] * 32768) / 32768).astype(np.float32)
    pcm = clip.astype("<f4").tobytes()
    code, a = _post(f"{http_server}/asr", pcm, {"Content-Type": "application/octet-stream",
                                                 "X-Language": "en"})
    assert code == 200 and a["success"] and a["language"] == "en"
    boundary = "PORTB"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"language\"\r\n\r\nen\r\n"
            f"--{boundary}\r\nContent-Disposition: form-data; name=\"wav\"; filename=\"a.wav\"\r\n"
            "Content-Type: audio/wav\r\n\r\n").encode() + _wav_bytes(clip) + \
        f"\r\n--{boundary}--\r\n".encode()
    code, b = _post(f"{http_server}/transcribe", body,
                    {"Content-Type": f"multipart/form-data; boundary={boundary}"})
    assert code == 200 and b["success"] and b["language"] == "en"
    code, c = _post(f"{http_server}/asr?language=en", _wav_bytes(clip),
                    {"Content-Type": "audio/wav"})
    assert code == 200 and isinstance(c["text"], str)
    assert a["text"] == b["text"] == c["text"]


@pytest.mark.parametrize("case", ["size%4", "garbage wav", "no wav field", "bad beam",
                                  "hot temperature", "bad format", "bad language", "empty"])
def test_http_bad_inputs_answer_400(http_server, case):
    octet = {"Content-Type": "application/octet-stream"}
    pcm = np.zeros(1600, "<f4").tobytes()
    multi = {"Content-Type": "multipart/form-data; boundary=B"}
    data, headers = {
        "size%4": (b"abc", octet),
        "garbage wav": (b"not a wav at all", {"Content-Type": "audio/wav"}),
        "no wav field": (b"--B\r\nContent-Disposition: form-data; name=\"language\"\r\n\r\n"
                         b"zh\r\n--B--\r\n", multi),
        "bad beam": (pcm, {**octet, "X-Beam": "many"}),
        "hot temperature": (pcm, {**octet, "X-Temperature": "5"}),
        "bad format": (pcm, {**octet, "X-Format": "docx"}),
        "bad language": (pcm, {**octet, "X-Language": "xx"}),
        "empty": (b"", octet),
    }[case]
    code, res = _post_error(f"{http_server}/asr", data, headers)
    assert code == 400 and res["success"] is False


# options the server answered 501 until word timings were ported; format=srt
# builds its segments from word timings, so it turns word_timestamps on
FORMERLY_501_HTTP = {
    "word_timestamps": {"X-Word-Timestamps": "1"}, "format": {"X-Format": "srt"},
}


@pytest.mark.parametrize("option", list(FORMERLY_501_HTTP))
def test_http_unported_options_answer_501(http_server, option):
    """Both options are served now: 200 with the reply's words, or an srt
    body of numbered cues."""
    pcm = _clips(8, (1.0,))[0].astype("<f4").tobytes()
    req = urllib.request.Request(f"{http_server}/asr", data=pcm, headers={
        "Content-Type": "application/octet-stream", **FORMERLY_501_HTTP[option]})
    with urllib.request.urlopen(req, timeout=60) as r:
        code, body = r.status, r.read().decode()
    assert code == 200
    if option == "format":
        assert body.startswith("1\n") and " --> " in body
    else:
        reply = json.loads(body)
        assert isinstance(reply["words"], list) and reply["words"]


def test_http_beam_above_the_cap_answers_400(http_server):
    pcm = np.zeros(1600, "<f4").tobytes()
    code, res = _post_error(f"{http_server}/asr", pcm,
                            {"Content-Type": "application/octet-stream", "X-Beam": "9"})
    assert code == 400 and "1..8" in res["error"]


def test_client_module(http_server, tmp_path):
    """client.py against the live server, both protocols."""
    host, port = "127.0.0.1", int(http_server.rsplit(":", 1)[1])
    assert client.health(host, port)["status"] == "healthy"
    path = tmp_path / "c.wav"
    path.write_bytes(_wav_bytes(_clips(6, (0.4,))[0]))
    r1 = client.transcribe_file(str(path), host, port, use_multipart=True, timeout=60)
    r2 = client.transcribe_file(str(path), host, port, use_multipart=False, timeout=60)
    assert r1["success"] and r2["success"] and r1["text"] == r2["text"]
    r3 = client.transcribe_file(str(path), host, port, beam=3, timeout=60)
    assert r3["success"] and r3["beam_size"] == 3


def test_main_refuses_unported_flags_and_a_missing_card(monkeypatch):
    # ["--checkpoint", "x"]: a checkpoint file that does not exist
    for flags in (["--tp", "2"], ["--checkpoint", "x"]):
        assert serve_main(["--device", "cpu", *flags]) != 0, flags
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve_main(["--model_type", "test-nano"]) != 0  # cuda, the default, and no card


def _serve(*flags):
    """A ``python -m whisper_tpu_torch.serving`` process on test-nano, the
    CPU, port 0 and ``flags``; returns (process, its URL)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_tpu_torch.serving", "--model_type", "test-nano",
         "--device", "cpu", "--dtype", "float32", "--no-w8a8", "--host", "127.0.0.1",
         "--port", "0", "--max_tokens", "6", "--steps_per_sync", "4", *flags],
        stderr=subprocess.PIPE, text=True)
    line = ""
    deadline = time.monotonic() + 60
    while "server on" not in line and time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line and proc.poll() is not None:
            raise AssertionError("server exited")
    return proc, "http://" + line.split(" on ")[1].split(" ")[0]


def test_main_serves_on_the_cpu():
    """``python -m whisper_tpu_torch.serving --device cpu`` on test-nano
    answers octet-stream and multipart, a beam of 5 (400 above its
    ``--max_beam_size``) and word timestamps (the option answered 501
    before it was ported); started with
    ``--timestamps --encode_chunks 2`` it answers with timestamp tokens."""
    proc, url = _serve()
    try:
        pcm = _clips(7, (0.5,))[0].astype("<f4").tobytes()
        code, res = _post(f"{url}/asr", pcm, {"Content-Type": "application/octet-stream"})
        assert code == 200 and res["success"] and res["tokens"] <= 6
        body = (b"--B\r\nContent-Disposition: form-data; name=\"wav\"; filename=\"a.wav\"\r\n\r\n"
                + _wav_bytes(_clips(7, (0.5,))[0]) + b"\r\n--B--\r\n")
        code, res = _post(f"{url}/asr", body, {"Content-Type": "multipart/form-data; boundary=B"})
        assert code == 200 and isinstance(res["text"], str)
        code, res = _post(f"{url}/asr", pcm, {"Content-Type": "application/octet-stream",
                                             "X-Beam": "5"})
        assert code == 200 and res["success"]
        code, res = _post_error(f"{url}/asr", pcm, {"Content-Type": "application/octet-stream",
                                                   "X-Beam": "9"})
        assert code == 400
        code, res = _post(f"{url}/asr", pcm, {"Content-Type": "application/octet-stream",
                                             "X-Word-Timestamps": "1"})
        assert code == 200 and isinstance(res["words"], list) and "align_error" not in res
    finally:
        proc.terminate()
        proc.wait(timeout=20)
    proc, url = _serve("--timestamps", "--encode_chunks", "2", "--no-warm_start")
    try:
        code, res = _post(f"{url}/asr?language=en", pcm,
                          {"Content-Type": "application/octet-stream"})
        assert code == 200 and res["success"] and res["text"].startswith("<|")
    finally:
        proc.terminate()
        proc.wait(timeout=20)
