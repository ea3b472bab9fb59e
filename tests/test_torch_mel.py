"""The port's log-mel frontend against the JAX ``log_mel_batch`` (fp32), and
its fused raw log10 mel (K7) against the JAX package's Pallas kernel
``log10_mel_pallas`` in interpret mode and its jnp stage."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import HOP_LENGTH, N_FFT, N_SAMPLES
from whisper_tpu.ops.mel import _power_spectrum as jax_power_spectrum
from whisper_tpu.ops.mel import _dft_bank as jax_dft_bank
from whisper_tpu.ops.mel import log_mel_batch as jax_log_mel_batch
from whisper_tpu.ops.mel import log_mel_spectrogram as jax_log_mel_spectrogram
from whisper_tpu.ops.mel import mel_filterbank as jax_mel_filterbank
from whisper_tpu.ops.mel_pallas import log10_mel_pallas
from whisper_tpu_torch.ops.log10_mel import log10_mel, log10_mel_plain
from whisper_tpu_torch.ops.mel import (
    _dft_bank,
    log_mel_batch,
    log_mel_spectrogram,
    mel_filterbank,
)

torch.set_num_threads(2)

ATOL = 1e-4  # fp32 DFT/mel products summed in another order than XLA's
K7_TOL = 5e-4  # the JAX package's golden tolerance for its fused mel kernel


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


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log10_mel_plain_matches_pallas_and_jnp(n_mels):
    """Two clips (noise and a tone) reflect-padded as log_mel_batch pads
    them: the raw log10 mel within K7_TOL of the JAX Pallas kernel
    (interpret mode) and of the jnp DFT + filterbank stage."""
    rng = np.random.default_rng(n_mels)
    n = 16000 * 3
    t = np.arange(n) / 16000.0
    x = np.stack([rng.standard_normal(n) * 0.2, 0.3 * np.sin(2 * np.pi * 440 * t)])
    xp = np.pad(x, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect").astype(np.float32)
    n_frames = 1 + n // HOP_LENGTH
    got = log10_mel(torch.from_numpy(xp), n_mels, N_FFT, HOP_LENGTH, n_frames)
    assert got.shape == (2, n_mels, n_frames)
    pallas = np.asarray(log10_mel_pallas(jnp.asarray(xp), n_mels=n_mels, n_frames=n_frames,
                                         interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=K7_TOL)
    power = jax_power_spectrum(jnp.asarray(xp), N_FFT, HOP_LENGTH, n_frames=n_frames)
    stage = np.asarray(jnp.log10(jnp.maximum(
        jnp.einsum("mf,bft->bmt", jnp.asarray(jax_mel_filterbank(n_mels)), power), 1e-10)))
    np.testing.assert_allclose(got.numpy(), stage, rtol=0, atol=K7_TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  log10_mel_plain(torch.from_numpy(xp), n_mels, N_FFT,
                                                  HOP_LENGTH, n_frames).numpy())


def test_empty_rows_through_log_mel_batch():
    """The seek path pads its window batch with empty rows (length 0): as in
    JAX, one valid frame (the silent floor, (-10 + 4) / 4) and zeros after."""
    audio = np.zeros((2, N_SAMPLES), np.float32)
    audio[0, :16000] = np.random.default_rng(1).standard_normal(16000) * 0.1
    lengths = np.array([16000, 0], np.int32)
    ref = np.asarray(jax_log_mel_batch(jnp.asarray(audio), jnp.asarray(lengths), n_mels=80))
    got = log_mel_batch(torch.from_numpy(audio), torch.from_numpy(lengths), n_mels=80)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert float(got[1, :, 1:].abs().max()) == 0.0 and (got[1, :, 0] == -1.5).all()


def test_log10_mel_cpu_counts_no_launch():
    before = log10_mel.launches
    log10_mel(torch.zeros((1, 2000)), 80, N_FFT, HOP_LENGTH, 5)
    assert log10_mel.launches == before


@pytest.mark.parametrize("padding", ["feature_zero", "audio_zero"])
@pytest.mark.parametrize("seconds", [3.0048, 30.0, 33.5])
def test_log_mel_spectrogram_matches_jax(padding, seconds):
    """The exact-length path against the JAX ``log_mel_spectrogram``: under
    and over 30 s, cut or padded to 3000 frames and unpadded, both
    paddings; (n,) input. A cut spectrogram's last 50 frames are zero with
    ``feature_zero`` only."""
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    for pad_to in (3000, None):
        ref = np.asarray(jax_log_mel_spectrogram(jnp.asarray(audio), pad_to=pad_to,
                                                 padding=padding))
        got = log_mel_spectrogram(torch.from_numpy(audio), pad_to=pad_to, padding=padding)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    if n > 16000 * 30 and padding == "feature_zero":
        assert float(got.abs().max()) > 0  # (the unpadded one)
        cut = log_mel_spectrogram(audio, pad_to=3000, padding=padding)
        assert float(cut[..., -50:].abs().max()) == 0.0


def test_log_mel_spectrogram_batch_and_mels_match_jax():
    """(B, n) input and 128 mel bins."""
    audio = (np.random.default_rng(5).standard_normal((2, 20000)) * 0.1).astype(np.float32)
    ref = np.asarray(jax_log_mel_spectrogram(jnp.asarray(audio), n_mels=128))
    got = log_mel_spectrogram(torch.from_numpy(audio), n_mels=128)
    assert got.shape == ref.shape == (2, 128, 3000)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
