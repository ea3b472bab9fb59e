"""Seek-based long-form transcription of the port against the JAX package's
``transcribe_seek`` (fp32, same bridged weights): segments equal exactly,
texts equal, with condition-on-previous-text on and off and with an initial
prompt (which, without conditioning, primes the first window only). A
narrow config
(1-2 layers, width 64) that keeps turbo's 448-token text context, so the
223-token previous-text bucket fits, and a short audio context (the mel is
cut to its first 2 * n_audio_ctx frames, as in the pipeline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import WhisperConfig as JaxConfig
from whisper_tpu.longform import transcribe_seek as jax_transcribe_seek
from whisper_tpu.models.model import init_params as jax_init_params
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch import longform as tl
from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

FIELDS = dict(name="seek-narrow", n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2,
              n_audio_layer=1, n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=2,
              n_text_layer=2)
MAX_TOKENS = 12
CLIP_S = (40, 5)
CASES = {"condition": (True, None), "no_condition": (False, None),
         "initial_prompt": (False, "Ada and Grace's talk, 1843.")}


class _JaxPipe:
    """The attributes the JAX ``transcribe_seek`` reads from a pipeline."""

    def __init__(self, params, cfg, tokenizer, condition, initial_prompt):
        self.cfg, self.params, self.tokenizer = cfg, params, tokenizer
        self.compute_dtype = jnp.float32
        self.task = "transcribe"
        self.max_tokens = MAX_TOKENS
        self.kv_quant = self.self_kv_quant = False
        self.beam_size = 0
        self._suppress_ids = jax_suppress_ids(cfg, tokenizer)
        self.condition_on_previous_text = condition
        self.initial_prompt = initial_prompt
        self.no_speech_threshold, self.logprob_threshold = 0.6, -1.0


@pytest.fixture(scope="module")
def setup():
    cfg = JaxConfig(**FIELDS)
    jp = jax_init_params(cfg, jax.random.PRNGKey(5))
    rng = np.random.default_rng(21)
    waves = [(0.1 * rng.standard_normal(16000 * s)).astype(np.float32) for s in CLIP_S]
    tok = jax_get_tokenizer(True, num_languages=cfg.num_languages)
    ref = {case: jax_transcribe_seek(_JaxPipe(jp, cfg, tok, *args), waves, "en")
           for case, args in CASES.items()}
    model = from_jax_params(jax.tree.map(np.asarray, jp), WhisperConfig(**FIELDS), device="cpu")
    return model, waves, ref


@pytest.mark.parametrize("case", list(CASES))
def test_transcribe_seek_equals_jax(setup, case):
    model, waves, ref = setup
    condition, initial_prompt = CASES[case]
    pipe = WhisperPipeline(device="cpu", params=model, compute_dtype="float32",
                           max_tokens=MAX_TOKENS, language="en",
                           condition_on_previous_text=condition, initial_prompt=initial_prompt)
    got = pipe.transcribe_longform(waves)
    assert [r.text for r in got] == [text for text, _ in ref[case]]
    assert [r.segments for r in got] == [segs for _, segs in ref[case]]
    stats = pipe.last_seek
    assert stats["rounds"] >= 2 and stats["windows"] >= stats["rounds"]
    for r, w in zip(got, waves):
        assert r.audio_seconds == len(w) / 16000.0
        starts = [s0 for s0, _, _ in r.segments]
        assert starts == sorted(starts)
        # a window's timestamps span 30 s even when its audio is shorter, so
        # random weights may place a segment past the clip's end (as JAX does)
        for s0, s1, _ in r.segments:
            assert 0 <= s0 <= len(w) / 16000.0 + 30 and (s1 is None or s0 <= s1)


def test_prompts_bucket_previous_text():
    """Rows with previous text are right-aligned behind their pads; the
    prev region is bucketed to 16 / 64 / 223 tokens; a row without
    previous text masks [sot_prev, prev] whole."""

    class Tok:
        def encode(self, text):
            return list(range(100, 100 + len(text.split())))

    class Pipe:
        cfg = WhisperConfig(**FIELDS)
        condition_on_previous_text = True
        initial_prompt = None
        tokenizer = Tok()

    sot = np.asarray(Pipe.cfg.sot_sequence("en")[:-1], np.int64)
    for n_words, width in ((3, 16), (40, 64), (300, 223)):
        texts = [["w " * n_words], []]
        prompts, pads, sot_index = tl._prompts(Pipe, [0, 1], texts, 2, sot)
        assert prompts.shape == (2, 1 + width + 3) and sot_index == 1 + width
        n = min(n_words, 223)
        assert pads[0] == width - n and prompts[0, pads[0]] == Pipe.cfg.sot_prev
        assert list(prompts[0, pads[0] + 1:sot_index]) == list(range(100, 100 + n_words))[-n:]
        assert pads[1] == sot_index and (prompts[:, sot_index:] == sot).all()
    prompts, pads, sot_index = tl._prompts(Pipe, [0, 1], [[], []], 2, sot)
    assert pads is None and sot_index == 0 and prompts.shape == (2, 3)
    assert [tl._next_pow2(n) for n in (1, 2, 3, 5, 64, 100)] == [1, 2, 4, 8, 64, 64]
