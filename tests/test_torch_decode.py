"""Greedy tokens and pipeline texts of the port against the JAX package
(fp32, test-nano, apply_filters on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import quantize_params as jax_qparams
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import ROUND_STEPS, GreedyResult, encode_cross_kv, greedy_decode
from whisper_tpu_torch.models.model import KVCache, decoder_forward, encoder_forward
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
MAX_TOKENS = 10

COMBOS = {  # name: (quantized weights, kv_quant, self_kv_quant, w8a8)
    "plain": (False, False, False, False),
    "kvq": (False, True, False, False),
    "kvq+skvq": (False, True, True, False),
    "kvq+skvq+w8a8": (True, True, True, True),
}


def divergence(model, mel, w8a8, got, want):
    """(row, position, the port's top-2 logit margin there) of the first
    token that differs, the logits teacher-forced on ``want``'s prefix
    against the fp32 cross-KV of that row."""
    b, t = map(int, np.argwhere(got != want)[0])
    cross = encode_cross_kv(model, torch.from_numpy(mel[b:b + 1]), w8a8=w8a8)
    kv = KVCache.create(PCFG, 1, device="cpu")
    logits, _ = decoder_forward(model, torch.from_numpy(want[b:b + 1, :t]).long(), 0, kv, cross)
    top2 = torch.topk(logits[0, -1], 2).values
    return b, t, float(top2[0] - top2[1])


@pytest.mark.parametrize("combo", list(COMBOS))
def test_greedy_tokens_equal_jax(combo, monkeypatch):
    quant, kv_quant, self_kv_quant, w8a8 = COMBOS[combo]
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    if quant:
        jp = jax_qparams(jp)
    model = from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")
    mel = np.random.default_rng(7).standard_normal(
        (3, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int32), (3, 1))
    suppress = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))

    # JAX: the encoder unjitted (WHISPER_TPU_W8A8 is read at trace time),
    # then the jitted greedy loop
    monkeypatch.setenv("WHISPER_TPU_W8A8", "1" if w8a8 else "0")
    audio = jm.encoder_forward(jp, jnp.asarray(mel), CFG)
    jkv = jm.compute_cross_kv(jp, audio, CFG)
    if kv_quant:
        jkv = jm.quantize_cross_kv(jkv)
    ref = jax_greedy_decode_kv(jp, jkv, jnp.asarray(prompt), CFG, max_tokens=MAX_TOKENS,
                               suppress_ids=jnp.asarray(suppress), apply_filters=True,
                               self_kv_quant=self_kv_quant)

    res = greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompt),
                        kv_quant=kv_quant, w8a8=w8a8, max_tokens=MAX_TOKENS,
                        suppress_ids=torch.from_numpy(suppress).long(), apply_filters=True,
                        self_kv_quant=self_kv_quant)
    got, want = res.tokens.numpy(), np.asarray(ref.tokens)
    if not np.array_equal(got, want):
        b, t, margin = divergence(model, mel, w8a8, got, want)
        pytest.fail(f"{combo}: first divergence at row {b}, position {t} "
                    f"(port {got[b, t]}, JAX {want[b, t]}), top-2 logit margin {margin:.3g}")
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(res.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(res.avg_logprob.numpy(), np.asarray(ref.avg_logprob),
                               rtol=1e-4, atol=1e-5)
    # the loop's bookkeeping: one read of the all-done flag a round
    assert res.host_syncs == max(1, -(-res.steps // ROUND_STEPS)) and res.steps <= MAX_TOKENS - 1


def _bridged(quant=False):
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    if quant:
        jp = jax_qparams(jp)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


@pytest.mark.parametrize("combo", ["plain", "kvq+skvq"])
def test_greedy_tokens_with_timestamps_equal_jax(combo):
    """The timestamp grammar (sampling.apply_rules(timestamps=True)) decodes
    the same fp32 tokens as JAX from the seek path's prompt (the sot
    sequence without <|notimestamps|>)."""
    _, kv_quant, self_kv_quant, _ = COMBOS[combo]
    jp, model = _bridged()
    mel = np.random.default_rng(8).standard_normal(
        (3, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    prompt = np.tile(np.asarray([CFG.sot_sequence("en")[:-1]], np.int32), (3, 1))
    suppress = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
    jkv = jm.compute_cross_kv(jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG)
    if kv_quant:
        jkv = jm.quantize_cross_kv(jkv)
    ref = jax_greedy_decode_kv(jp, jkv, jnp.asarray(prompt), CFG, max_tokens=MAX_TOKENS,
                               suppress_ids=jnp.asarray(suppress), timestamps=True,
                               apply_filters=True, self_kv_quant=self_kv_quant)
    res = greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompt),
                        kv_quant=kv_quant, max_tokens=MAX_TOKENS,
                        suppress_ids=torch.from_numpy(suppress).long(), timestamps=True,
                        apply_filters=True, self_kv_quant=self_kv_quant)
    want = np.asarray(ref.tokens)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(ref.lengths))
    assert (want[:, prompt.shape[1]] >= CFG.timestamp_begin).all()  # the grammar ran
    np.testing.assert_allclose(res.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("combo", ["plain", "kvq+skvq"])
def test_padded_prompts_equal_jax(combo):
    """Right-aligned [sot_prev, *prev, sot, lang, task] prompts with mixed
    left pads (a row without previous text masks its whole prev region)
    and sot_index: tokens equal to JAX's, no_speech_prob within 1e-5."""
    _, kv_quant, self_kv_quant, _ = COMBOS[combo]
    jp, model = _bridged()
    mel = np.random.default_rng(9).standard_normal(
        (3, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    base = list(CFG.sot_sequence("en")[:-1])
    prevs = [[CFG.sot_prev, 11, 22, 33, 44, 55, 66], [CFG.sot_prev, 300], []]
    P = 1 + 6 + len(base)
    prompt = np.full((3, P), CFG.eot, np.int32)
    pads = np.full((3,), P - len(base), np.int32)
    prompt[:, -len(base):] = base
    for b, pv in enumerate(prevs):
        if pv:
            pads[b] = P - len(base) - len(pv)
            prompt[b, pads[b]:P - len(base)] = pv
    sot_index = P - len(base)
    suppress = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
    jkv = jm.compute_cross_kv(jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG)
    if kv_quant:
        jkv = jm.quantize_cross_kv(jkv)
    ref = jax_greedy_decode_kv(jp, jkv, jnp.asarray(prompt), CFG, max_tokens=MAX_TOKENS,
                               suppress_ids=jnp.asarray(suppress), timestamps=True,
                               apply_filters=True, self_kv_quant=self_kv_quant,
                               prompt_pad=jnp.asarray(pads), sot_index=sot_index)
    res = greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompt),
                        kv_quant=kv_quant, max_tokens=MAX_TOKENS,
                        suppress_ids=torch.from_numpy(suppress).long(), timestamps=True,
                        apply_filters=True, self_kv_quant=self_kv_quant,
                        prompt_pad=torch.from_numpy(pads).long(), sot_index=sot_index)
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(res.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=0, atol=1e-5)


def test_pipeline_timestamps_and_initial_prompt_equal_jax():
    """transcribe_batch with timestamps (no <|notimestamps|>) and an
    initial_prompt prefix gives the JAX pipeline's texts, tokens and
    segments."""
    kw = dict(compute_dtype="float32", max_tokens=8, language="en", timestamps=True,
              initial_prompt="Hello there, it's 2 o'clock.")
    jpipe = JaxPipeline(model="test-nano", **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jpipe.params), PCFG, device="cpu")
    tpipe = WhisperPipeline(device="cpu", params=params, **kw)
    rng = np.random.default_rng(12)
    clips = [(0.1 * rng.standard_normal(16000 * s)).astype(np.float32) for s in (5, 12)]
    ref = jpipe.transcribe_batch(clips)
    got = tpipe.transcribe_batch(clips)
    assert [r.text for r in got] == [r.text for r in ref]
    assert [r.segments for r in got] == [r.segments for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_divergence_report():
    """The report a token mismatch would print names the first differing
    position and a margin."""
    from whisper_tpu_torch.params import init_params

    model = init_params(PCFG, seed=2, device="cpu")
    mel = np.zeros((2, CFG.n_mels, 2 * CFG.n_audio_ctx), np.float32)
    want = np.tile(np.asarray(CFG.sot_sequence("zh") + (100, 200, 300)), (2, 1))
    got = want.copy()
    got[1, 5] = 7
    b, t, margin = divergence(model, mel, False, got, want)
    assert (b, t) == (1, 5) and np.isfinite(margin) and margin >= 0


def test_pipeline_texts_equal_jax():
    """Same bridged weights: a 5 s clip and a 35 s one (two windows whose
    texts are merged) give the JAX pipeline's texts and tokens."""
    kw = dict(compute_dtype="float32", max_tokens=8, quantize=True, kv_quant=True,
              self_kv_quant=True, language="zh")
    jpipe = JaxPipeline(model="test-nano", **kw)
    params = from_jax_params(jax.tree.map(np.asarray, jpipe.params), PCFG, device="cpu")
    tpipe = WhisperPipeline(device="cpu", params=params, **kw)
    rng = np.random.default_rng(11)
    clips = [(0.1 * rng.standard_normal(16000 * s)).astype(np.float32) for s in (5, 35)]
    ref = jpipe.transcribe_batch(clips)
    got = tpipe.transcribe_batch(clips)
    assert [r.text for r in got] == [r.text for r in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.language == b.language == "zh"


def test_pipeline_refuses_unported_options(tmp_path):
    """Nothing of the pipeline is refused any more. Both spellings of a
    speculative draft (a preset, a checkpoint file) build a pipeline with a
    draft that decodes (held against JAX in test_torch_spec_pipeline.py).
    Word timestamps are served (held
    against JAX in test_torch_words_serving.py): a result carries its word
    list. Beams 0 and 1 decode greedily (beams above 1 are held against JAX
    in test_torch_beam_serving.py). Timestamps, initial_prompt, seek-based
    long-form, sampling and its ladder, checkpoints and the auto language
    are ported (tests below, in test_torch_longform.py, test_torch_ladder.py,
    test_torch_checkpoint.py and test_torch_language.py)."""
    from test_torch_checkpoint import DIMS, openai_state_dict

    path = str(tmp_path / "draft.pt")
    sd = openai_state_dict(jax.tree.map(np.asarray, jm.init_params(CFG, jax.random.PRNGKey(1))),
                           CFG)
    torch.save({"dims": DIMS, "model_state_dict": {k: torch.from_numpy(v.copy())
                                                   for k, v in sd.items()}}, path)
    for kw in (dict(spec_draft="test-nano"), dict(spec_draft_checkpoint=path)):
        pipe = WhisperPipeline(model="test-nano", device="cpu", apply_filters=False,
                               max_tokens=4, **kw)
        assert pipe.draft is not None and pipe.draft.cfg.n_vocab == pipe.cfg.n_vocab
        pipe.transcribe_batch([np.zeros(16000, np.float32)])
        assert pipe.last_spec_stats["rounds"] == pipe.last_decode.rounds >= 1
    pipe = WhisperPipeline(model="test-nano", device="cpu", word_timestamps=True, max_tokens=4,
                           language="en")
    (res,) = pipe.transcribe_batch([np.random.default_rng(2).standard_normal(16000)
                                    .astype(np.float32) * 0.1])
    assert isinstance(res.words, list) and res.words
    for beam in (0, 1):
        pipe = WhisperPipeline(model="test-nano", device="cpu", beam_size=beam, max_tokens=4)
        pipe.transcribe_batch([np.zeros(16000, np.float32)])
        assert isinstance(pipe.last_decode, GreedyResult)
    pipe = WhisperPipeline(model="test-nano", device="cpu", timestamps=True,
                           initial_prompt="hi", max_tokens=4)
    (res,) = pipe.transcribe_longform([np.zeros(16000, np.float32)])
    assert isinstance(res.segments, list) and res.segments is res.segments_list


def test_pipeline_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        WhisperPipeline(model="test-nano", device="cuda")


def test_encoder_kernel_count_is_zero_on_cpu():
    """On CPU tensors the wrappers run their plain versions: no launches."""
    from whisper_tpu_torch.ops.flash_attention import flash_attention_btd

    before = flash_attention_btd.launches
    from whisper_tpu_torch.params import init_params

    model = init_params(PCFG, seed=1, device="cpu")
    encoder_forward(model, torch.zeros((1, CFG.n_mels, 2 * CFG.n_audio_ctx)))
    assert flash_attention_btd.launches == before
