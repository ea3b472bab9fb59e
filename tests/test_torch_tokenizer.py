"""The port's tiktoken-free tokenizer against the JAX package's (tiktoken)."""

import numpy as np
import pytest

from whisper_tpu.config import get_config
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.sampling import build_suppress_ids
from whisper_tpu_torch.tokenizer import get_tokenizer


@pytest.fixture(scope="module", params=[99, 100], ids=["99lang", "100lang"])
def pair(request):
    n = request.param
    return (get_tokenizer(num_languages=n, language="zh", task="transcribe"),
            jax_get_tokenizer(True, num_languages=n, language="zh", task="transcribe"))


def test_special_ids(pair):
    tok, ref = pair
    for name in ("eot", "sot", "transcribe", "translate", "sot_lm", "sot_prev",
                 "no_speech", "no_timestamps", "timestamp_begin"):
        assert getattr(tok, name) == getattr(ref, name), name
    assert tok.sot_sequence == ref.sot_sequence
    assert tok.to_language_token("yue" if tok.num_languages == 100 else "su") == \
        ref.to_language_token("yue" if ref.num_languages == 100 else "su")


def test_decode_random_id_runs(pair):
    """Random runs over the whole vocab (text, specials, timestamps), and
    runs that split multi-byte UTF-8 characters."""
    tok, ref = pair
    rng = np.random.default_rng(0)
    n_vocab = ref.timestamp_begin + 1501
    for _ in range(50):
        ids = rng.integers(0, n_vocab, rng.integers(1, 40)).tolist()
        assert tok.decode(ids) == ref.decode(ids)
        assert tok.decode_with_timestamps(ids) == ref.decode_with_timestamps(ids)
    for _ in range(50):
        ids = rng.integers(0, ref.eot, rng.integers(1, 40)).tolist()
        assert tok.decode(ids) == ref.decode(ids)


def test_encode_single_pieces(pair):
    """Plain byte-pair merging equals tiktoken on strings the GPT-2
    pre-tokenizer keeps whole."""
    tok, ref = pair
    for s in [" hello", "world", " -", " '", "((", " ♪♪", "「", " 你好", "1234", "<<<"]:
        assert tok.encode(s) == ref.encode(s), s


CORPUS = [
    "Hello, world! I'm here; you're there. We've seen they'll go, she'd say it's done.",
    "DON'T SHOUT'S 're 'll ''s '' 's", "abc123def 4567 ab12 3.14 1,000,000 2nd 3rd",
    "x² ½ Ⅻ 3½ Ⅻa ²b", "你好，世界。这是一个测试。 こんにちは 세계",
    "emoji 😀🎉 👍🏽 ok❤️", "  two  spaces\n\nnew lines \t tab\n", "   ", " \n", "a\n b",
    "trailing   ", "\u3000full-width space", "’s don’t", "__init__ a_b -- --- <<< >>>",
    '"#()*+/:;<=>@[\\]^_`{|}~「」『』 ♪♪ ((music)) [[x]] {{y}} ♩♪♫♬♭♮♯',
    "x\x1c y\r\nz",
]


def test_encode_corpus_equals_tiktoken(pair):
    """The GPT-2 pre-tokenizer plus byte-pair merging gives tiktoken's ids:
    contractions, digits among letters, numbers that are not digits (², ½,
    Ⅻ), CJK, emoji, runs of spaces and newlines, the non-speech symbols."""
    tok, ref = pair
    for s in CORPUS:
        assert tok.encode(s) == ref.encode(s), s
    rng = np.random.default_rng(5)
    alphabet = list("ab '’12²½Ⅻ你 \n\t😀.,!?-_") + ["'s", "'ll", "  "]
    for _ in range(300):
        s = "".join(rng.choice(alphabet, rng.integers(1, 14)))
        assert tok.encode(s) == ref.encode(s), s


def test_non_speech_and_suppress_ids(pair):
    tok, ref = pair
    assert tok.non_speech_tokens == ref.non_speech_tokens
    name = "turbo" if tok.num_languages == 100 else "tiny"
    np.testing.assert_array_equal(build_suppress_ids(port_config(name), tok),
                                  jax_suppress_ids(get_config(name), ref))
