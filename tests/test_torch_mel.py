"""The port's log-mel frontend against the JAX ``log_mel_batch`` (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import N_SAMPLES
from whisper_tpu.ops.mel import _dft_bank as jax_dft_bank
from whisper_tpu.ops.mel import log_mel_batch as jax_log_mel_batch
from whisper_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from whisper_tpu_torch.ops.mel import _dft_bank, log_mel_batch, mel_filterbank

torch.set_num_threads(2)

ATOL = 1e-4  # fp32 DFT/mel products summed in another order than XLA's


@pytest.mark.parametrize("n_mels", [80, 128])
def test_banks_equal(n_mels):
    np.testing.assert_array_equal(mel_filterbank(n_mels), jax_mel_filterbank(n_mels))
    np.testing.assert_array_equal(_dft_bank(), jax_dft_bank())


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_batch_matches_jax(n_mels):
    """A full-length clip (zeroed 50-frame tail), a short one (masked max,
    zero features past its frames) and one a hop past a frame boundary."""
    rng = np.random.default_rng(0)
    lengths = np.array([N_SAMPLES, 3 * 16000 + 77, 16000], np.int32)
    audio = np.zeros((3, N_SAMPLES), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        audio[i, :n] = (0.3 * np.sin(2 * np.pi * (300 + 200 * i) * t)
                        + 0.05 * rng.standard_normal(n)).astype(np.float32)
    ref = np.asarray(jax_log_mel_batch(jnp.asarray(audio), jnp.asarray(lengths), n_mels=n_mels))
    got = log_mel_batch(torch.from_numpy(audio), torch.from_numpy(lengths), n_mels=n_mels)
    assert got.shape == ref.shape == (3, n_mels, 3000)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # the padding semantics themselves: zero tail / zero past the valid frames
    assert float(got[0, :, -50:].abs().max()) == 0.0
    assert float(got[2, :, 16000 // 160 + 1:].abs().max()) == 0.0
