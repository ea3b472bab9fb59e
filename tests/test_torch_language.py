"""Language auto-detection in the port against the JAX package (test-nano,
fp32, on the CPU, where the kernel wrappers run their plain versions):
``detect_language`` / ``detect_language_kv`` (ids equal, probabilities
within 1e-4: the same fp32 step, summed in another order), the pipeline with
``language=None`` (languages and tokens equal), the engine's
``language="auto"`` on its slot path and its aux worker, the CLI's
``--language auto --checkpoint`` and the server's ``language=auto``.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.decode import detect_language as jax_detect
from whisper_tpu.decode import detect_language_kv as jax_detect_kv
from whisper_tpu.models import model as jm
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch import cli
from whisper_tpu_torch.config import LANGUAGES
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import detect_language, detect_language_kv, encode_cross_kv
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.serving.server import make_server
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
CODES = list(LANGUAGES)
PROB_TOL = 1e-4  # fp32 softmax of the same logits, summed in another order


class IdTok:
    """Decodes to the ids themselves, so a reply carries its tokens."""

    def __init__(self):
        self.non_speech_tokens = get_tokenizer(num_languages=PCFG.num_languages).non_speech_tokens

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(1))


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")


def _mel(seed, b=4):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _check_detect(got, want, probs_got, probs_want):
    probs_got = probs_got.numpy()
    probs_want = np.asarray(probs_want)
    np.testing.assert_allclose(probs_got, probs_want, atol=PROB_TOL, rtol=0)
    top2 = np.sort(probs_want, axis=-1)[:, -2:]
    # ids equal (a row whose top two probabilities sit within the tolerance
    # would be a near tie: none of these inputs has one)
    assert (top2[:, 1] - top2[:, 0] > 2 * PROB_TOL).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_quant", [False, True], ids=["plain", "int8"])
def test_detect_language_equals_jax(jax_params, kv_quant):
    """``detect_language`` (encoder + float cross-KV) and
    ``detect_language_kv`` against the plain or the int8 cross-KV."""
    model, mel = _model(jax_params), _mel(5)
    if kv_quant:
        audio = jm.encoder_forward(jax_params, jnp.asarray(mel), CFG)
        want = jax_detect_kv(jax_params, jm.quantize_cross_kv(
            jm.compute_cross_kv(jax_params, audio, CFG)), CFG)
        got = detect_language_kv(model, encode_cross_kv(model, torch.from_numpy(mel),
                                                        kv_quant=True))
    else:
        want = jax_detect(jax_params, jnp.asarray(mel), CFG)
        got = detect_language(model, torch.from_numpy(mel))
    assert got[1].shape == (4, PCFG.num_languages) and got[0].dtype == torch.int64
    _check_detect(got[0], want[0], got[1], want[1])


def test_detect_language_kv_under_self_kv_quant(jax_params):
    """The detection step's self-KV is a float cache whatever the caller's
    self-KV quantization: the pipeline with ``self_kv_quant`` detects what
    ``detect_language_kv`` does."""
    model = _model(jax_params)
    pipe = WhisperPipeline(device="cpu", params=model, compute_dtype="float32", language=None,
                           kv_quant=True, self_kv_quant=True, max_tokens=2)
    clips = _clips(9, (3, 7))
    res = pipe.transcribe_batch(clips)
    jp = JaxPipeline(model="test-nano", compute_dtype="float32", language=None, kv_quant=True,
                     self_kv_quant=True, max_tokens=2)
    jp.params = jax_params
    assert [r.language for r in res] == [r.language for r in jp.transcribe_batch(clips)]


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "kvq+skvq"])
def test_pipeline_auto_language_equals_jax(jax_params, quant):
    """``language=None``: per-chunk detection from the batch's cross-KV; a
    5 s clip and a 35 s one (two chunks, the utterance taking the first's
    language): languages, tokens and texts equal JAX's."""
    kw = dict(compute_dtype="float32", max_tokens=6, language=None, kv_quant=quant,
              self_kv_quant=quant)
    jpipe = JaxPipeline(model="test-nano", **kw)
    jpipe.params = jax_params
    pipe = WhisperPipeline(device="cpu", params=_model(jax_params), **kw)
    clips = _clips(11, (5, 35))
    want = jpipe.transcribe_batch(clips)
    got = pipe.transcribe_batch(clips)
    for a, b in zip(got, want):
        assert a.language == b.language and a.language in CODES
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.text == b.text
    # the prompts the decode ran with carry each chunk's detected language
    prompt = pipe.last_decode.tokens[:, :4].numpy()
    assert [CODES[t - PCFG.lang_token_start] for t in prompt[:, 1]][0] == got[0].language


def _engine(jax_params, **kw):
    opts = dict(max_slots=4, compute_dtype=torch.float32, steps_per_sync=2, max_tokens=6,
                kv_quant=True, self_kv_quant=True, no_speech_threshold=None,
                logprob_threshold=None, compression_ratio_threshold=None)
    opts.update(kw)
    return ContinuousBatchingEngine(_model(jax_params), IdTok(), **opts)


def _run(engine, futs, limit=60):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return [f.result(0) for f in futs]
        engine._tick()
        engine.aux_round()
    raise AssertionError(f"requests not done after {limit} ticks")


def test_engine_auto_language(jax_params):
    """The contract of the JAX engine's test: ``language='auto'`` resolves to
    a concrete code (and the reply counts one detection batch)."""
    eng = _engine(jax_params)
    (res,) = _run(eng, [eng.submit(Request(audio=_clips(1, (0.5,))[0], language="auto"))])
    assert res["success"] and res["language"] in CODES
    assert eng.stats.detect_batches_total == 1


def test_engine_auto_language_immutable_request(jax_params):
    """Detection never mutates ``Request.language``: the code goes into
    ``language_resolved`` and the reply."""
    eng = _engine(jax_params)
    req = Request(audio=_clips(2, (0.5,))[0], language="auto")
    (res,) = _run(eng, [eng.submit(req)])
    assert req.language == "auto"
    assert res["language"] in CODES and req.language_resolved == res["language"]


def test_engine_auto_language_equals_jax_engine(jax_params):
    """One admission batch of auto and explicit rows: the auto rows' replies
    name the JAX engine's detected language with its tokens; the explicit
    rows decode as they do in a batch without auto rows."""
    clips = _clips(3, (0.6, 2.5, 1.2, 4.0))
    langs = ["auto", "zh", "auto", "en"]
    jeng = JaxEngine(jax_params, CFG, IdTok(), max_slots=4, compute_dtype=jnp.float32,
                     steps_per_sync=2, max_tokens=6, kv_quant=True, self_kv_quant=True,
                     no_speech_threshold=None, logprob_threshold=None,
                     compression_ratio_threshold=None)
    want_f = [jeng.submit(JaxRequest(audio=c, language=lang)) for c, lang in zip(clips, langs)]
    for _ in range(40):
        if all(f.done() for f in want_f):
            break
        jeng._tick()
    want = [f.result(0) for f in want_f]
    eng = _engine(jax_params)
    got = _run(eng, [eng.submit(Request(audio=c, language=lang))
                     for c, lang in zip(clips, langs)])
    assert eng.stats.detect_batches_total == 1
    for g, w, lang in zip(got, want, langs):
        assert g["language"] == w["language"] and g["language"] in CODES
        assert g["text"] == w["text"]
        if lang != "auto":
            assert g["language"] == lang
    plain = _engine(jax_params)
    alone = _run(plain, [plain.submit(Request(audio=clips[i], language=langs[i])) for i in (1, 3)])
    assert [r["text"] for r in alone] == [got[1]["text"], got[3]["text"]]
    assert plain.stats.detect_batches_total == 0


def test_engine_auto_language_on_the_aux_worker(jax_params):
    """A sampled auto request (``temperature > 0``) detects on the aux
    worker, reads the slot path's language for the same clip, and keeps
    ``language='auto'``; so does one the ladder sends there from the slots
    (a logprob floor of 0 fails every greedy result), which detects again."""
    clip = _clips(4, (1.5,))[0]
    eng = _engine(jax_params)
    (slot,) = _run(eng, [eng.submit(Request(audio=clip, language="auto"))])
    req = Request(audio=clip, language="auto", temperature=0.7)
    (aux,) = _run(eng, [eng.submit(req)])
    assert aux["language"] == slot["language"] == req.language_resolved
    assert req.language == "auto" and eng.stats.aux_batches_total == 1
    ladder = _engine(jax_params, temperature_fallback=(0.5,), logprob_threshold=0.0)
    req = Request(audio=clip, language="auto")
    (res,) = _run(ladder, [ladder.submit(req)])
    assert res["attempts"] == 2 and res["temperature"] == 0.5
    assert res["language"] == slot["language"] and req.language == "auto"
    assert ladder.stats.detect_batches_total == 2  # admission, then the aux retry


def test_cli_language_auto_with_checkpoint(jax_params, tmp_path, capsys):
    """``--checkpoint`` (an OpenAI-named ``.pt``, no dims, with
    ``--model_type``) and ``--language auto``: the printed language is the
    JAX pipeline's detection on the same file and clip. (Only the language
    is held: a checkpoint turns the ladder on, and the JAX pipeline's ladder
    cannot run on this JAX, ROADMAP fault 3.6.)"""
    from test_torch_checkpoint import openai_state_dict

    path = str(tmp_path / "nano.pt")
    sd = openai_state_dict(jax.tree.map(np.asarray, jax_params), CFG)
    torch.save({k: torch.tensor(v) for k, v in sd.items()}, path)
    wav = str(tmp_path / "a.wav")
    with open(wav, "wb") as f:
        f.write(_wav(np.round(_clips(6, (2.0,))[0] * 32767).astype("<i2").tobytes()))
    rc = cli.main(["--wav", wav, "--model_type", "test-nano", "--checkpoint", path,
                   "--language", "auto", "--device", "cpu", "--dtype", "float32",
                   "--max_tokens", "4"])
    assert rc == 0
    got = capsys.readouterr().out.strip().splitlines()[-1].split("\t")[1].strip("[]")
    want = JaxPipeline(model="test-nano", checkpoint=path, compute_dtype="float32",
                       language=None, max_tokens=4, temperature_fallback=False)
    assert got == want.transcribe(wav).language and got in CODES


def _wav(pcm: bytes) -> bytes:
    """16-bit mono 16 kHz WAV of ``pcm``."""
    import struct

    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_http_language_auto_answers_200(jax_params):
    """``language=auto`` over HTTP reaches the engine: 200 and a detected
    code, equal to the engine's own for the same PCM."""
    eng = _engine(jax_params).start()
    srv = make_server(eng, "127.0.0.1", 0, request_timeout_s=60)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = _clips(8, (0.8,))[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/asr", data=clip.astype("<f4").tobytes(),
            headers={"Content-Type": "application/octet-stream", "X-Language": "auto"})
        with urllib.request.urlopen(req, timeout=60) as r:
            status, res = r.status, json.load(r)
        direct = eng.transcribe(clip, language="auto", timeout=60)
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()
        t.join(timeout=10)
    assert status == 200 and res["success"] and res["language"] in CODES
    assert res["language"] == direct["language"] and res["text"] == direct["text"]
