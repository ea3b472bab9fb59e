"""``tiny`` at full width against the JAX package (CPU, fp32, the same
bridged weights from JAX's ``init_params``): two seeded 30 s clips, one mel
for both, each package's ``encode_cross_kv`` and 16 greedy tokens of its
``greedy_decode_kv``.

Tolerance: the tokens must be equal. A row that differs passes only if
JAX's top-2 logit margin at the first divergence (teacher-forced on JAX's
own prefix) is under ``NEAR_TIE`` = 1e-4, a tie that fp32 sums in another
order may break either way; the failure message reports that margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from whisper_tpu import decode as jdecode
from whisper_tpu.config import N_SAMPLES, get_config
from whisper_tpu.models import model as jm
from whisper_tpu.ops.mel import log_mel_batch
from whisper_tpu_torch import decode as tdecode
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.params import from_jax_params

torch.set_num_threads(4)

NEAR_TIE = 1e-4
N_TOKENS = 16


def _jax_margin(params, cfg, cross, row: int, prefix: list) -> float:
    """JAX's top-2 logit margin after ``prefix`` for ``row`` of ``cross``."""
    one = tuple(x[:, row: row + 1] for x in cross)
    tokens = jnp.asarray([prefix], jnp.int32)
    kv = jm.KVCache.create(cfg, 1)
    logits, _ = jm.decoder_forward(params, tokens, 0, kv, one, cfg)
    top2 = jax.lax.top_k(logits[0, -1], 2)[0]
    return float(top2[0] - top2[1])


def test_tiny_greedy_tokens_equal_jax():
    cfg, pcfg = get_config("tiny"), port_config("tiny")
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg, device="cpu")
    rng = np.random.default_rng(16)
    lengths = (int(16000 * 7.5), N_SAMPLES)
    audio = np.zeros((2, N_SAMPLES), np.float32)
    for i, n in enumerate(lengths):
        audio[i, :n] = rng.standard_normal(n) * 0.1
    mel = np.array(log_mel_batch(jnp.asarray(audio), jnp.asarray(lengths, np.int32),
                                  n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx])
    prompt = np.asarray([cfg.sot_sequence("zh", "transcribe")] * 2)
    P = prompt.shape[1]

    jcross = jdecode.encode_cross_kv(params, jnp.asarray(mel), cfg)
    want = jdecode.greedy_decode_kv(params, jcross, jnp.asarray(prompt, jnp.int32), cfg,
                                    max_tokens=N_TOKENS)
    tcross = tdecode.encode_cross_kv(model, torch.from_numpy(mel))
    got = tdecode.greedy_decode_kv(model, tcross, torch.from_numpy(prompt).to(torch.int64),
                                   max_tokens=N_TOKENS)
    w_toks, w_lens = np.asarray(want.tokens), np.asarray(want.lengths)
    g_toks, g_lens = got.tokens.numpy(), got.lengths.numpy()
    for row in range(2):
        w = w_toks[row, P: w_lens[row]].tolist()
        g = g_toks[row, P: g_lens[row]].tolist()
        if g == w:
            continue
        t = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        margin = _jax_margin(params, cfg, jcross, row, prompt[row].tolist() + w[:t])
        assert margin < NEAR_TIE, (
            f"row {row} differs from JAX at token {t} (port {g[t:t + 1]}, JAX {w[t:t + 1]}); "
            f"JAX's top-2 margin there is {margin:.3g}, not a near tie (< {NEAR_TIE})")
    # the rows decode past the prompt, and to different tokens
    assert (w_lens > P).all() and w_toks[0, P:].tolist() != w_toks[1, P:].tolist()
