"""Log-mel spectrogram frontend.

Port of ``whisper_tpu/ops/mel.py``'s fixed-shape batched path. The Hann
window, the DFT bank and the slaney mel filterbank are numpy copies. The raw
log10 mel (framing, windowed DFT, power, mel projection, log10) is
:func:`~whisper_tpu_torch.ops.log10_mel.log10_mel`, the hand-written fused
kernel on the card and its plain framed-copy + fp32 matmul version on the
CPU; the reflect padding, the per-utterance masked -8 dB clamp and the
zeroed tail stay here, as they stay outside the TPU kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES, SAMPLE_RATE

ZERO_TAIL_FRAMES = 50  # frames zeroed for full-length audio


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep, mels)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT, sr: int = SAMPLE_RATE,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)."""
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(np.array(fmin)), hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bank(n_fft: int = N_FFT) -> np.ndarray:
    """Periodic-Hann-windowed cos/sin DFT bank, (n_fft, 2*(n_fft//2+1))."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    k = np.arange(n_freqs)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    cos_b = np.cos(ang) * window[None, :]
    sin_b = -np.sin(ang) * window[None, :]
    return np.concatenate([cos_b, sin_b], axis=0).astype(np.float32).T


def _frame(audio_padded: torch.Tensor, n_frames: int, n_fft: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, n_frames, n_fft): frame f is hop-chunks [f, f+1, f+2]
    concatenated and cut to n_fft."""
    B, L = audio_padded.shape
    k = -(-n_fft // hop)
    need = (n_frames + k - 1) * hop
    if L < need:
        audio_padded = F.pad(audio_padded, (0, need - L))
    chunks = audio_padded[:, :need].reshape(B, n_frames + k - 1, hop)
    parts = [chunks[:, i : i + n_frames] for i in range(k)]
    return torch.cat(parts, dim=-1)[:, :, :n_fft]


def log_mel_batch(audio: torch.Tensor, lengths: torch.Tensor, n_mels: int = 80,
                  n_fft: int = N_FFT, hop: int = HOP_LENGTH) -> torch.Tensor:
    """Fixed-shape batched log-mel.

    audio: (B, N_SAMPLES) zero-padded float32; lengths: (B,) true sample
    counts. Returns (B, n_mels, 3000) fp32: per-utterance masked max for the
    -8 dB clamp, zero features beyond the valid frames, last 50 frames zeroed
    for full-length audio.
    """
    from .log10_mel import log10_mel  # it imports this module's banks

    device = audio.device
    x = F.pad(audio.to(torch.float32)[:, None, :], (n_fft // 2, n_fft // 2),
              mode="reflect")[:, 0]
    log_spec = log10_mel(x.contiguous(), n_mels, n_fft, hop, N_FRAMES)  # (B, n_mels, T)

    lengths = lengths.to(device=device, dtype=torch.int64)
    n_valid = torch.clamp(lengths // hop + 1, max=N_FRAMES)
    n_valid = torch.where(lengths >= N_SAMPLES,
                          torch.full_like(n_valid, N_FRAMES - ZERO_TAIL_FRAMES), n_valid)
    valid = torch.arange(N_FRAMES, device=device)[None, :] < n_valid[:, None]
    masked = torch.where(valid[:, None, :], log_spec,
                         torch.full_like(log_spec, float("-inf")))
    per_max = masked.amax(dim=(1, 2))
    feats = (torch.maximum(log_spec, per_max[:, None, None] - 8.0) + 4.0) / 4.0
    return torch.where(valid[:, None, :], feats, torch.zeros_like(feats))
