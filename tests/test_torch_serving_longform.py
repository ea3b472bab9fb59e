"""Requests over 30 s, streaming and the served formats in the port, against
the JAX engine and server (CPU, test-nano, fp32, int8 cross- and self-KV, the
same bridged weights): the fan-out of overlapping windows and its merge,
the conditioned sequential windows, the long-form partials, and over HTTP
``stream``, ``format=txt``, ``initial_prompt``, ``condition_on_previous``
and audio over 30 s. Engines are driven with ``_tick()`` where they are
compared; the HTTP tests bind port 0 and wait with timeouts.
"""

import http.client
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.formats import render_payload as jax_render_payload
from whisper_tpu.longform import merge_texts as jax_merge_texts
from whisper_tpu.models import model as jm
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch.config import N_SAMPLES
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.longform import split_audio
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
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
ENGINE = dict(max_slots=4, steps_per_sync=2, max_tokens=6, kv_quant=True, self_kv_quant=True,
              no_speech_threshold=None, logprob_threshold=None,
              compression_ratio_threshold=None)
SEED = 3  # weights whose greedy decodes differ from clip to clip


class IdTok:
    """Decodes to the ids themselves; encodes prompts and suppresses
    non-speech as the real tokenizer does."""

    eot = PCFG.eot

    def __init__(self):
        tok = get_tokenizer(num_languages=PCFG.num_languages)
        self.non_speech_tokens = tok.non_speech_tokens
        self.encode = tok.encode

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode

    def split_to_word_tokens(self, ids):
        """One word a token, for word timings."""
        return [f" {int(i)}" for i in ids], [[int(i)] for i in ids]


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(SEED))


def _port(jax_params, **kw):
    model = from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")
    return ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32,
                                    **{**ENGINE, **kw})


def _jax(jax_params, **kw):
    return JaxEngine(jax_params, CFG, IdTok(), compute_dtype=jnp.float32, **{**ENGINE, **kw})


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _run(pairs, limit=200):
    for _ in range(limit):
        if all(f.done() for _, futs in pairs for f in futs):
            return
        for eng, _ in pairs:
            eng._tick()
    raise AssertionError(f"requests not done after {limit} ticks")


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("overlap_s", [2.0, 5.0])
def test_engine_longform_split_and_merge(jax_params, overlap_s):
    """A 75 s request is split into overlapping windows (3 at a 2 s overlap,
    3 at 5 s) decoded as ordinary requests and merged: the reply equals the
    JAX engine's (text, windows, tokens, quality fields), and its text is
    the merge of the windows decoded one by one."""
    wav = _clips(51, (75.0,))[0]
    port = _port(jax_params, longform_overlap_s=overlap_s)
    jeng = _jax(jax_params, longform_overlap_s=overlap_s)
    got = port.submit(Request(audio=wav, language="zh"))
    want = jeng.submit(JaxRequest(audio=wav, language="zh"))
    _run([(port, [got]), (jeng, [want])])
    got, want = got.result(0), want.result(0)
    keys = ("text", "windows", "tokens", "language", "quality_ok", "audio_seconds")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["windows"] == 3 and got["audio_seconds"] == pytest.approx(75.0)
    waves, _ = split_audio(wav, N_SAMPLES, port.longform_overlap)
    parts = []
    for w in waves:
        f = port.submit(Request(audio=w, language="zh"))
        _run([(port, [f])])
        parts.append(f.result(0)["text"])
    assert got["text"] == jax_merge_texts(parts, "zh")


def test_engine_conditioned_longform_sequential(jax_params):
    """condition_on_previous decodes a 75 s request's windows one after
    another, each prompted with the initial prompt and the transcript so far:
    the windows' prompts and the merged reply equal the JAX engine's."""
    wav = _clips(52, (75.0,))[0]
    seen = {"port": [], "jax": []}
    port, jeng = _port(jax_params), _jax(jax_params)
    for name, eng in (("port", port), ("jax", jeng)):
        real = eng._prepare_batch

        def spy(newcomers, *a, _real=real, _seen=seen[name], **k):
            _seen.extend(r.initial_prompt for r in newcomers)
            return _real(newcomers, *a, **k)

        eng._prepare_batch = spy
    kw = dict(audio=wav, language="zh", condition_on_previous=True, initial_prompt="seed words")
    got, want = port.submit(Request(**kw)), jeng.submit(JaxRequest(**kw))
    _run([(port, [got]), (jeng, [want])])
    got, want = got.result(0), want.result(0)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 3
    assert seen["port"][0] == "seed words" and seen["port"][1].startswith("seed words ")
    assert len(seen["port"][2]) > len(seen["port"][1])
    keys = ("text", "windows", "conditioned", "tokens", "language")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["conditioned"] is True and port.stats.encode_batches_total == 3


def test_longform_partials_match_jax(jax_params):
    """on_partial on a request over 30 s: each window's partials are relayed
    merged behind the windows before it, in the JAX engine's sequence, for
    the fan-out and for the conditioned windows."""
    wav = _clips(53, (40.0,))[0]
    for cond in (False, True):
        seen = {"port": [], "jax": []}
        port, jeng = _port(jax_params, steps_per_sync=1), _jax(jax_params, steps_per_sync=1)
        got = port.submit(Request(audio=wav, language="zh", condition_on_previous=cond,
                                  on_partial=seen["port"].append))
        want = jeng.submit(JaxRequest(audio=wav, language="zh", condition_on_previous=cond,
                                      on_partial=seen["jax"].append))
        _run([(port, [got]), (jeng, [want])])
        assert seen["port"] == seen["jax"] and len(seen["port"]) >= 4, cond
        assert got.result(0)["text"] == want.result(0)["text"]


def test_conditioned_window_on_a_full_queue_fails_the_parent(jax_params):
    """The next conditioned window is submitted from the decode thread's
    harvest: when another client fills the queue just before it, the parent
    fails with OverloadedError, and the engine serves the other request."""
    eng = _port(jax_params, max_queue=1)
    parent = eng.submit(Request(audio=_clips(54, (40.0,))[0], language="zh",
                                condition_on_previous=True))
    other = Request(audio=_clips(55, (1.0,))[0], language="zh")
    real, sent = eng._harvest_host, []

    def harvest(done_h, *args, **kw):
        # a client's request lands just before window 0 resolves
        if done_h[0] and eng._slot_req[0] is not None and not sent:
            sent.append(eng.submit(other))
        return real(done_h, *args, **kw)

    eng._harvest_host = harvest
    for _ in range(40):
        if parent.done():
            break
        eng._tick()
    with pytest.raises(OverloadedError, match="queue full"):
        parent.result(0)
    _run([(eng, [other.future])])
    assert other.future.result(0)["success"]


def test_longform_refuses_what_the_queue_cannot_hold(jax_params):
    """A fan-out needing more window slots than the queue has is refused at
    submit, as in JAX."""
    eng = _port(jax_params, max_queue=2)
    with pytest.raises(OverloadedError, match="3 windows"):
        eng.submit(Request(audio=np.zeros(16000 * 75, np.float32)))


# ---------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def server(jax_params):
    eng = _port(jax_params, steps_per_sync=1).start(warm=False)
    srv = make_server(eng, "127.0.0.1", 0, request_timeout_s=120)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"127.0.0.1:{srv.server_address[1]}", eng
    srv.shutdown()
    srv.server_close()
    eng.stop()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(host, path, data, headers, timeout=120):
    req = urllib.request.Request(f"http://{host}{path}", data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read().decode()


OCTET = {"Content-Type": "application/octet-stream"}


def _stream(host, path, data, headers):
    conn = http.client.HTTPConnection(*host.split(":"), timeout=120)
    try:
        conn.request("POST", path, body=data, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type", ""), \
            [json.loads(line) for line in resp.read().decode().splitlines() if line]
    finally:
        conn.close()


@pytest.mark.parametrize("seconds", [1.6, 40.0], ids=["short", "long"])
def test_http_streaming(server, seconds):
    """X-Stream: 1 answers chunked NDJSON: partials that grow, then a final
    line equal to the JSON reply for the same clip."""
    host, _ = server
    pcm = _clips(56, (seconds,))[0].astype("<f4").tobytes()
    code, ctype, lines = _stream(host, "/asr?language=zh", pcm, {**OCTET, "X-Stream": "1"})
    assert code == 200 and "ndjson" in ctype
    *partials, final = lines
    assert partials and all("partial" in p for p in partials)
    texts = [p["partial"] for p in partials]
    assert len(set(texts)) == len(texts)  # a line only when the transcript changed
    _, _, body = _post(host, "/asr?language=zh", pcm, OCTET)
    reply = json.loads(body)
    drop = ("wall_seconds", "rtf")
    assert {k: v for k, v in final.items() if k not in drop} == \
        {k: v for k, v in reply.items() if k not in drop}
    if seconds < 30:
        assert all(final["text"].startswith(t) for t in texts)


def test_http_format_txt_equals_jax_render(server):
    """format=txt renders the reply through the CLI's txt writer, as JAX's
    render_payload does the same payload, as text/plain."""
    host, _ = server
    pcm = _clips(57, (1.2,))[0].astype("<f4").tobytes()
    code, ctype, text = _post(host, "/asr?language=zh&format=txt", pcm, OCTET)
    _, _, body = _post(host, "/asr?language=zh", pcm, OCTET)
    assert code == 200 and ctype.startswith("text/plain")
    assert text == jax_render_payload(json.loads(body), "txt")


def test_http_stream_with_a_subtitle_format_is_400(server):
    host, _ = server
    pcm = np.zeros(1600, "<f4").tobytes()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(host, "/asr", pcm, {**OCTET, "X-Stream": "1", "X-Format": "srt"})
    assert ei.value.code == 400 and "stream" in json.load(ei.value)["error"]


@pytest.mark.parametrize("fmt", ["srt", "vtt", "tsv"])
def test_http_subtitle_formats_need_word_timestamps(server, fmt):
    """srt, vtt and tsv are built from word timings, so the server turns
    word_timestamps on for them (as the JAX server does; they answered 501
    before word timings were ported): 200, and the body is the JAX writer's
    rendering of the same clip's JSON reply with word_timestamps=1."""
    host, _ = server
    pcm = _clips(58, (1.5,))[0].astype("<f4").tobytes()
    code, ctype, text = _post(host, f"/asr?format={fmt}", pcm, OCTET)
    _, _, body = _post(host, "/asr?word_timestamps=1", pcm, OCTET)
    reply = json.loads(body)
    assert code == 200 and isinstance(reply["words"], list) and reply["words"]
    assert text == jax_render_payload(reply, fmt)
    assert {"srt": " --> ", "vtt": "WEBVTT", "tsv": "start\tend\ttext"}[fmt] in text


def test_http_initial_prompt(server):
    """initial_prompt as a query parameter, a multipart field and a UTF-8
    X-Initial-Prompt header reaches the engine: all three equal the engine's
    own reply for that prompt, and differ from the plain reply."""
    host, eng = server
    clip = _clips(58, (0.9,))[0]
    pcm = clip.astype("<f4").tobytes()
    prompt = "héllo wörld"
    plain = json.loads(_post(host, "/asr?language=zh", pcm, OCTET)[2])
    q = json.loads(_post(host, "/asr?language=zh&initial_prompt="
                         + urllib.parse.quote(prompt), pcm, OCTET)[2])
    h = json.loads(_post(host, "/asr?language=zh", pcm,
                         {**OCTET, "X-Initial-Prompt": prompt.encode().decode("latin-1")})[2])
    wav_body = _wav(clip)
    body = (b"--B\r\nContent-Disposition: form-data; name=\"initial_prompt\"\r\n\r\n"
            + prompt.encode() + b"\r\n--B\r\nContent-Disposition: form-data; name=\"language\""
            b"\r\n\r\nzh\r\n--B\r\nContent-Disposition: form-data; name=\"wav\"; "
            b"filename=\"a.wav\"\r\n\r\n" + wav_body + b"\r\n--B--\r\n")
    m = json.loads(_post(host, "/asr", body,
                         {"Content-Type": "multipart/form-data; boundary=B"})[2])
    ref = eng.submit(Request(audio=clip, language="zh", initial_prompt=prompt)).result(60)
    wav_clip = np.round(clip * 32768).astype(np.int16).astype(np.float32) / 32768
    ref_wav = eng.submit(Request(audio=wav_clip, language="zh", initial_prompt=prompt)).result(60)
    assert q["text"] == h["text"] == ref["text"] != plain["text"]
    assert m["text"] == ref_wav["text"]


def _wav(x: np.ndarray) -> bytes:
    import struct

    pcm = np.round(x * 32768).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_http_asr_long_audio(server):
    """A 65 s octet-stream request is served whole: three windows, merged."""
    host, _ = server
    pcm = _clips(59, (65.0,))[0].astype("<f4").tobytes()
    reply = json.loads(_post(host, "/asr?language=zh", pcm, OCTET)[2])
    assert reply["success"] and reply["windows"] == 3
    assert reply["audio_seconds"] == pytest.approx(65.0) and "conditioned" not in reply


def test_http_conditioned_longform(server):
    """X-Condition-On-Previous on a 70 s request takes the sequential path."""
    host, eng = server
    before = eng.stats.encode_batches_total
    pcm = _clips(60, (70.0,))[0].astype("<f4").tobytes()
    reply = json.loads(_post(host, "/asr?language=zh&initial_prompt=seed", pcm,
                             {**OCTET, "X-Condition-On-Previous": "1"})[2])
    assert reply["success"] and reply["windows"] == 3 and reply["conditioned"] is True
    assert eng.stats.encode_batches_total - before == 3  # one admission a window


# ---------------------------------------------------------------- entry point
def test_main_builds_the_engine_options():
    """--timestamps, --encode_chunks, --adaptive_sync and --router_overlap_s
    reach the engine the entry point builds."""
    args = parse_args(["--model_type", "test-nano", "--device", "cpu", "--dtype", "float32",
                       "--no-w8a8", "--timestamps", "--encode_chunks", "2", "--adaptive_sync",
                       "--router_overlap_s", "3.5", "--max_tokens", "6"])
    eng, _ = build_engine(args)
    assert eng.timestamps and eng.encode_chunks == 2 and eng.adaptive_sync
    assert eng.longform_overlap == 56000 and len(eng._encode_seg_fns) == 2
