"""Speculative decoding through the port's pipeline and CLI against the JAX
package's (CPU, fp32, test-nano, the same bridged weights).

The target is test-nano at seed 3 (its greedy decodes differ from clip to
clip). The draft is the target with seeded noise of 0.1 of each matrix's
spread added, so that part of its proposals are accepted and the
``last_spec_stats`` counts are not trivial, handed to both pipelines (the
port's as ``draft_params=``); the checkpoint tests write both models as
OpenAI-named ``.pt`` files without dims (ROADMAP fault 3.8) and give them to
both packages as ``checkpoint`` and ``spec_draft_checkpoint``. Texts,
tokens, languages and ``last_spec_stats`` must be equal; word timings as
``tests/test_torch_words_serving.py`` holds them.
"""

import jax
import numpy as np
import pytest
import torch

import whisper_tpu.pipeline
from whisper_tpu import cli as jax_cli
from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import quantize_params as jax_qparams
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu_torch import cli
from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.params import from_jax_params, init_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.spec_decode import SPEC_ROUNDS, SpecResult

from test_torch_checkpoint import openai_state_dict
from test_torch_ladder import _CopyingNumpy, _with_jax_noise
from test_torch_spec_decode import _near
from test_torch_words_serving import _same

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
SPEC = dict(model="test-nano", compute_dtype="float32", apply_filters=False, max_tokens=8,
            language="zh", spec_draft="test-nano", spec_gamma=3)


@pytest.fixture(scope="module")
def weights():
    """(target, draft) JAX trees."""
    target = jm.init_params(CFG, jax.random.PRNGKey(3))
    return target, _near(target)


def _port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree), PCFG, device="cpu")


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _pipelines(weights, **kw):
    """The JAX pipeline and the port's, over the same target and draft."""
    target, draft = weights
    if kw.get("quantize"):
        target, draft = jax_qparams(target), jax_qparams(draft)
    jpipe = JaxPipeline(**{**SPEC, **kw})
    jpipe.params, jpipe.draft_params = target, draft
    tpipe = WhisperPipeline(device="cpu", params=_port(target), draft_params=_port(draft),
                            **{**SPEC, **kw})
    return jpipe, tpipe


def _assert_same(got, want, tpipe, jpipe):
    assert [r.text for r in got] == [r.text for r in want]
    assert [r.language for r in got] == [r.language for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    stats = tpipe.last_spec_stats  # JAX's counts, and the port's rounds on the device
    assert {k: stats[k] for k in jpipe.last_spec_stats} == jpipe.last_spec_stats
    assert stats["device_rounds"] == stats["host_syncs"] * SPEC_ROUNDS >= stats["rounds"]


# name: (pipeline keywords, clip seconds)
CASES = {
    "fp32": ({}, (2.0, 5.0, 1.0)),
    "int8-gamma4": (dict(quantize=True, kv_quant=True, self_kv_quant=True, spec_gamma=4),
                    (3.0, 4.0)),
    "gamma1": (dict(spec_gamma=1, max_tokens=6), (2.0, 3.0)),
    "language-auto": (dict(language=None), (2.0, 5.0)),
    "initial-prompt": (dict(initial_prompt="the quick brown fox"), (2.0, 4.0)),
    "over-30s": (dict(kv_quant=True), (35.0, 2.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_spec_equals_jax(weights, case):
    """``transcribe_batch`` with a draft: texts, tokens, languages and the
    acceptance counts equal JAX's; the decode is a ``SpecResult`` whose
    tokens are the port's own greedy decode's (the exactness invariant)."""
    kw, seconds = CASES[case]
    jpipe, tpipe = _pipelines(weights, **kw)
    clips = _clips(21, seconds)
    want, got = jpipe.transcribe_batch(clips), tpipe.transcribe_batch(clips)
    _assert_same(got, want, tpipe, jpipe)
    spec = tpipe.last_decode
    assert isinstance(spec, SpecResult) and spec.rounds == tpipe.last_spec_stats["rounds"]
    assert 0 < tpipe.last_spec_stats["accepted"] <= tpipe.last_spec_stats["drafted"]
    tpipe.draft = None  # the same pipeline, greedy
    greedy = tpipe.transcribe_batch(clips)
    assert [r.text for r in greedy] == [r.text for r in got]
    np.testing.assert_array_equal(tpipe.last_decode.tokens.numpy(), spec.tokens.numpy())


def test_pipeline_spec_with_word_timestamps_equals_jax(weights):
    """Word timestamps compose with the speculative result: the words of a
    3 s clip and a 40 s one (two windows merged) equal JAX's."""
    jpipe, tpipe = _pipelines(weights, word_timestamps=True, language="en")
    clips = _clips(41, (3.0, 40.0))
    want, got = jpipe.transcribe_batch(clips), tpipe.transcribe_batch(clips)
    _assert_same(got, want, tpipe, jpipe)
    for a, b in zip(got, want):
        _same(a.words, b.words)
        assert a.words


def test_pipeline_spec_with_the_ladder_equals_jax(weights, monkeypatch):
    """The ladder composes with the speculative result: every random-weight
    row fails the logprob gate and is re-decoded by sampling (JAX's draws
    handed to the port, the JAX ladder on writable copies, ROADMAP fault
    3.6); texts and tokens equal JAX's, and the spec counts are the first
    decode's."""
    jpipe, tpipe = _pipelines(weights, temperature_fallback=True, kv_quant=True)
    monkeypatch.setattr(whisper_tpu.pipeline, "np", _CopyingNumpy())
    calls = []
    _with_jax_noise(monkeypatch, calls)
    clips = _clips(12, (2.0, 5.0))
    want, got = jpipe.transcribe_batch(clips), tpipe.transcribe_batch(clips)
    assert calls == [(t, int(t * 1000)) for t in (0.2, 0.4, 0.6, 0.8, 1.0)]
    _assert_same(got, want, tpipe, jpipe)


@pytest.fixture(scope="module")
def pt_files(weights, tmp_path_factory):
    """The target and the draft as OpenAI-named ``.pt`` files, no dims."""
    d = tmp_path_factory.mktemp("spec")
    out = {}
    for name, tree in zip(("target", "draft"), weights):
        out[name] = str(d / f"{name}.pt")
        sd = openai_state_dict(jax.tree.map(np.asarray, tree), CFG)
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, out[name])
    return out


def test_pipeline_spec_draft_checkpoint_equals_jax(weights, pt_files):
    """``checkpoint`` + ``spec_draft_checkpoint`` in both packages (the
    ladder off: fault 3.6) give the same texts, tokens and counts, and the
    port's result from the file equals its result from ``draft_params=``."""
    kw = dict(SPEC, checkpoint=pt_files["target"], spec_draft_checkpoint=pt_files["draft"],
              temperature_fallback=False, kv_quant=True, self_kv_quant=True)
    jpipe = JaxPipeline(**kw)
    tpipe = WhisperPipeline(device="cpu", **kw)
    clips = _clips(5, (2.0, 6.0))
    want, got = jpipe.transcribe_batch(clips), tpipe.transcribe_batch(clips)
    _assert_same(got, want, tpipe, jpipe)
    kw.pop("spec_draft_checkpoint")
    kw.pop("checkpoint")
    bridged = WhisperPipeline(device="cpu", params=_port(weights[0]),
                              draft_params=_port(weights[1]), **kw)
    assert [r.text for r in bridged.transcribe_batch(clips)] == [r.text for r in got]
    assert bridged.last_spec_stats == tpipe.last_spec_stats


def _other_vocab_draft():
    cfg = WhisperConfig(name="other-vocab", n_mels=80, n_audio_ctx=64, n_audio_state=32,
                        n_audio_head=2, n_audio_layer=1, n_vocab=51866, n_text_ctx=32,
                        n_text_state=32, n_text_head=2, n_text_layer=1, num_languages=100)
    return init_params(cfg, 0, device="cpu")


REFUSALS = {
    "apply_filters": dict(spec_draft="test-nano", apply_filters=True),
    "timestamps": dict(spec_draft="test-nano", timestamps=True),
    "beam": dict(spec_draft="test-nano", beam_size=2),
    "temperature": dict(spec_draft="test-nano", temperature=0.5),
    "checkpoint-with-random-draft": dict(spec_draft="test-nano", checkpoint="target"),
    "draft_params-and-checkpoint": dict(draft_params="draft", spec_draft_checkpoint="draft"),
    "vocabulary": dict(draft_params="other-vocab"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_pipeline_refuses_what_jax_refuses(pt_files, case):
    """Each combination the JAX pipeline refuses raises ``ValueError`` in
    the port too (JAX's own raise checked where JAX can build the case),
    and so do both spellings of one draft at once."""
    kw = dict(REFUSALS[case])
    for key in ("checkpoint", "spec_draft_checkpoint"):
        if key in kw:
            kw[key] = pt_files[kw[key]]
    base = dict(model="test-nano", compute_dtype="float32", apply_filters=False)
    if "draft_params" not in kw:
        with pytest.raises(ValueError):
            JaxPipeline(**{**base, **kw})
    elif kw["draft_params"] == "other-vocab":
        kw["draft_params"] = _other_vocab_draft()
    else:
        kw["draft_params"] = init_params(PCFG, 1, device="cpu")
    with pytest.raises(ValueError):
        WhisperPipeline(device="cpu", **{**base, **kw})


def test_longform_refuses_a_draft(weights):
    """The seek loop decodes with the timestamp grammar: with a draft both
    pipelines refuse it."""
    jpipe, tpipe = _pipelines(weights)
    clip = _clips(3, (2.0,))
    for pipe in (jpipe, tpipe):
        with pytest.raises(ValueError, match="longform"):
            pipe.transcribe_longform(clip)


def _write_wav(path, clip):
    import struct

    pcm = np.round(np.clip(clip, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
                + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
                + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_cli_spec_flags_equal_jax(pt_files, tmp_path, capsys, monkeypatch):
    """``--spec_draft``, ``--spec_draft_checkpoint`` and ``--spec_gamma``
    as in ``whisper_tpu/cli.py``: the same defaults, the same printed text
    for the same files (a checkpoint turns both ladders on: JAX's draws
    handed to the port, JAX's ladder on writable copies), the stderr line
    on the filters and the closing acceptance line, equal to JAX's."""
    assert (cli.get_args(["--wav", "a.wav"]).spec_gamma
            == jax_cli.get_args(["--wav", "a.wav"]).spec_gamma == 4)
    monkeypatch.setenv("WHISPER_TPU_XLA_CACHE", "0")  # the JAX CLI's compile cache
    monkeypatch.setattr(whisper_tpu.pipeline, "np", _CopyingNumpy())
    _with_jax_noise(monkeypatch, [])
    wav = str(tmp_path / "a.wav")
    _write_wav(wav, _clips(8, (3.0,))[0])
    argv = ["--wav", wav, "--model_type", "test-nano", "--checkpoint", pt_files["target"],
            "--dtype", "float32", "--max_tokens", "6", "--spec_draft", "test-nano",
            "--spec_draft_checkpoint", pt_files["draft"], "--spec_gamma", "3"]
    out = {}
    for name, main, extra in (("jax", jax_cli.main, []), ("port", cli.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        cap = capsys.readouterr()
        out[name] = (cap.out.splitlines(),
                     [line for line in cap.err.splitlines() if line.startswith("speculative")])
    assert out["port"] == out["jax"]
    lines = out["port"][1]
    assert lines[0] == ("speculative decoding: suppression filters disabled "
                        "(greedy/argmax-only path)")
    assert lines[1].startswith("speculative: acceptance ") and "rounds)" in lines[1]
