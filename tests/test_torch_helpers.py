"""The JAX package's small public helpers in the port, each against JAX's
on the same inputs: the tokenizer's language helpers and
``sot_sequence_including_notimestamps``, ``load_id2token``,
``ops.audio.write_wav`` and ``ops.quant.quantized_bytes`` with
``QTensor.shape`` / ``QTensor.dequant``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.ops import audio as jax_audio
from whisper_tpu.ops import quant as jq
from whisper_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from whisper_tpu.tokenizer import load_id2token as jax_load_id2token
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.ops import audio
from whisper_tpu_torch.ops import quant
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.tokenizer import find_vocab_file, get_tokenizer, load_id2token

HELPERS = ("all_language_tokens", "all_language_codes", "sot_sequence",
           "sot_sequence_including_notimestamps")


@pytest.mark.parametrize("language,task", [("zh", "transcribe"), ("en", "translate"),
                                           (None, None)])
@pytest.mark.parametrize("n", [99, 100])
def test_tokenizer_helpers_equal_jax(n, language, task):
    tok = get_tokenizer(num_languages=n, language=language, task=task)
    ref = jax_get_tokenizer(True, num_languages=n, language=language, task=task)
    for name in HELPERS:
        assert getattr(tok, name) == getattr(ref, name), name
    assert len(tok.all_language_codes) == n
    if language is None:
        for t in (tok, ref):
            with pytest.raises(ValueError, match="no language"):
                t.language_token
    else:
        assert tok.language_token == ref.language_token


def test_load_id2token_equals_jax(tmp_path):
    """A tokens file written from the vocab (base64 token, space, id per
    line; a blank line and ids out of order among them)."""
    with open(find_vocab_file()) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    rng = np.random.default_rng(0)
    picked = [lines[i] for i in rng.permutation(len(lines))[:5000]]
    path = tmp_path / "tiny-tokens.txt"
    path.write_text("\n".join(picked[:100] + [""] + picked[100:]) + "\n")
    got, want = load_id2token(str(path)), jax_load_id2token(str(path))
    assert got == want and len(got) == 5000
    assert all(isinstance(v, bytes) for v in got.values())


@pytest.mark.parametrize("rate", [16000, 8000])
def test_write_wav_bytes_equal_jax(tmp_path, rate):
    """Mono float32 to 16-bit PCM: the same bytes, samples past +-1 and a
    (1, n) array among them."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4001) * 0.6).astype(np.float32)
    x[:4] = (1.5, -1.5, 1.0, -1.0)
    for i, samples in enumerate((x, x[None, :], x.astype(np.float64))):
        a, b = tmp_path / f"port{i}.wav", tmp_path / f"jax{i}.wav"
        audio.write_wav(str(a), samples, rate)
        jax_audio.write_wav(str(b), samples, rate)
        assert a.read_bytes() == b.read_bytes()
    back, sr = audio.parse_wav(a.read_bytes())
    assert sr == rate and back.shape[-1] == len(x)


def test_quantized_bytes_equals_jax():
    """test-nano plain, after ``quantize_params`` and after
    ``quantize_logits_emb``; the count stays after a weight is laid out
    K-major in place."""
    cfg, pcfg = get_config("test-nano"), port_config("test-nano")
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    assert quant.quantized_bytes(model) == jq.quantized_bytes(params)
    params = jq.quantize_params(params)
    quant.quantize_params(model)
    assert quant.quantized_bytes(model) == jq.quantized_bytes(params)
    params = jq.quantize_logits_emb(params)
    quant.quantize_logits_emb(model)
    assert quant.quantized_bytes(model) == jq.quantized_bytes(params)
    model.encoder.blocks[0].attn["wq"].k_major()
    assert quant.quantized_bytes(model) == jq.quantized_bytes(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qtensor_shape_and_dequant_equal_jax(dtype):
    """The same payload and scales on both sides (JAX's quantizer is a
    jitted program whose scales may sit an ulp from the port's)."""
    w = np.random.default_rng(2).standard_normal((3, 64, 96)).astype(np.float32)
    ref = jq.quantize_weight(w, axis=-1)
    q, s = np.array(ref.q), np.array(ref.s)
    got = quant.QTensor(torch.from_numpy(q), torch.from_numpy(s))
    assert tuple(got.shape) == tuple(ref.shape) == w.shape
    assert tuple(quant.quantize_weight(torch.from_numpy(w)).shape) == w.shape
    want = np.asarray(ref.dequant(getattr(jnp, dtype)))
    out = got.dequant(getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(got.dequant().numpy(), np.asarray(ref.dequant()))
