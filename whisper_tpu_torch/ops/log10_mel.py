"""Fused raw log10-mel (K7): framing, Hann-windowed DFT, power, mel
projection and log10 in one pass.

``log10_mel`` is the port of the TPU kernel
``whisper_tpu/ops/mel_pallas.py:log10_mel_pallas`` (``_mel_kernel``):
reflect-padded audio (B, L) fp32 -> raw log10 mel (B, n_mels, n_frames)
fp32, before normalization. On a CUDA tensor it launches the hand-written
Hopper kernel ``whisper_tpu_torch/csrc/log10_mel.cu`` (a float64 FFT of
200 = 8 x 25 points in shared memory, the sparse mel stage and log10 in
fp32; see the note there); on a CPU tensor it runs :func:`log10_mel_plain`,
the framed-copy and two fp32 matmuls that
:func:`~whisper_tpu_torch.ops.mel.log_mel_batch` ran before.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .mel import _frame, mel_filterbank

N_FFT, HOP = 400, 160  # the only framing the CUDA kernel takes

# The kernel's FFT table in this order (offsets in elements; complex entries
# are (re, im) pairs, W_n = exp(-2 pi i / n)):
HANN = 0          # 400: the periodic Hann window
TW200 = 400       # 200 complex: W_200^(m2 * k1) at [m2 * 8 + k1], m2 < 25, k1 < 8
TW25 = 800        # 25 complex: W_25^(b * c) at [b * 5 + c], b, c < 5
TW400 = 850       # 101 complex: W_400^k, k <= 100 (the real-FFT split)
CONST = 1052      # cos(2 pi/5), sin(2 pi/5), cos(4 pi/5), sin(4 pi/5), sqrt(1/2)
TABLE_FLOATS = 1060  # padded to a multiple of 4


def fft_table() -> np.ndarray:
    """The twiddle and window table of the kernel's FFT (layout above) in
    float64, the FFT's precision (an fp32 FFT's error at near-zero bins adds
    to the plain version's past the 5e-4 the kernel is held to; PERF.md).
    Every value is computed here: none is formed by a recurrence on the
    card."""
    t = np.zeros(TABLE_FLOATS, np.float64)
    n = np.arange(N_FFT)
    t[HANN:HANN + N_FFT] = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))

    def put(off, w):
        t[off:off + 2 * w.size:2], t[off + 1:off + 2 * w.size:2] = w.real, w.imag

    m2, k1 = np.meshgrid(np.arange(25), np.arange(8), indexing="ij")
    put(TW200, np.exp(-2j * np.pi * (m2 * k1).ravel() / 200))
    b, c = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    put(TW25, np.exp(-2j * np.pi * (b * c).ravel() / 25))
    put(TW400, np.exp(-2j * np.pi * np.arange(101) / 400))
    t[CONST:CONST + 5] = (np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5), np.cos(4 * np.pi / 5),
                          np.sin(4 * np.pi / 5), np.sqrt(0.5))
    return t


@functools.lru_cache(maxsize=4)
def _dft_bank_f64(n_fft: int) -> np.ndarray:
    """``mel._dft_bank`` (the windowed cos/sin bank, (n_fft, 2 * (n_fft // 2
    + 1))) kept in float64."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    ang = 2.0 * np.pi * np.arange(n_freqs)[:, None] * n[None, :] / n_fft
    return np.concatenate([np.cos(ang) * window, -np.sin(ang) * window], axis=0).T


def log10_mel_plain(audio_padded: torch.Tensor, n_mels: int, n_fft: int, hop: int,
                    n_frames: int) -> torch.Tensor:
    """Plain version, all fp32: frames @ windowed DFT bank, |.|^2, mel
    filterbank @ power, log10(max(., 1e-10))."""
    device = audio_padded.device
    frames = _frame(audio_padded.to(torch.float32).double(), n_frames, n_fft, hop)
    bank = torch.from_numpy(_dft_bank_f64(n_fft)).to(device)
    spec = torch.matmul(frames, bank)  # (B, T, 2F) float64
    n_freqs = n_fft // 2 + 1
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = (re * re + im * im).to(torch.float32).transpose(1, 2)  # (B, F, T)
    mel = torch.matmul(torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(device), power)
    return torch.log10(torch.clamp(mel, min=1e-10))


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    """The kernel's constant inputs on ``device``: the FFT table
    (:func:`fft_table`, float64) and the mel filterbank packed
    by filter: filter m's weights of bins [lo[m], lo[m] + start[m+1] -
    start[m]) (its nonzero span) at ``weights[start[m]:start[m+1]]``; lo
    (n_mels,) and start (n_mels + 1,) int32."""
    fb = mel_filterbank(n_mels, N_FFT)
    lo = np.zeros(n_mels, np.int32)
    start = np.zeros(n_mels + 1, np.int32)
    spans = []
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        lo[m] = nz[0] if len(nz) else 0
        spans.append(fb[m, lo[m]:nz[-1] + 1] if len(nz) else fb[m, :0])
        start[m + 1] = start[m] + len(spans[-1])
    weights = np.concatenate(spans).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (fft_table(), weights, lo, start))


_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _kernel():
    fn = _build.load("log10_mel").log10_mel_f32
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def log10_mel(audio_padded: torch.Tensor, n_mels: int, n_fft: int = N_FFT,
              hop: int = HOP, n_frames: int = 3000) -> torch.Tensor:
    """Raw log10 mel of reflect-padded audio (B, L): (B, n_mels, n_frames)
    fp32; frame f is samples [f * hop, f * hop + n_fft), zeros past L.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (fp32, contiguous, n_fft 400, hop 160) or raise.
    """
    if audio_padded.device.type == "cpu":
        return log10_mel_plain(audio_padded, n_mels, n_fft, hop, n_frames)
    if audio_padded.device.type != "cuda":
        raise ValueError(f"log10_mel runs on cpu or cuda, not {audio_padded.device}")
    if (n_fft, hop) != (N_FFT, HOP):
        raise ValueError(f"the CUDA kernel takes n_fft {N_FFT} and hop {HOP}, got {n_fft}, {hop}")
    if audio_padded.dim() != 2 or audio_padded.dtype != torch.float32:
        raise ValueError(f"audio_padded must be (B, L) fp32, got {tuple(audio_padded.shape)} "
                         f"{audio_padded.dtype}")
    if not audio_padded.is_contiguous():
        raise ValueError("audio_padded must be contiguous")
    if n_mels < 1 or n_frames < 1:
        raise ValueError(f"n_mels and n_frames must be positive, got {n_mels}, {n_frames}")
    B, L = audio_padded.shape
    out = torch.empty((B, n_mels, n_frames), dtype=torch.float32, device=audio_padded.device)
    if B == 0:
        return out
    table, weights, lo, start = _tables(n_mels, audio_padded.device)
    err = _build.launch(_kernel(), audio_padded.device, audio_padded.data_ptr(), L, B,
                        n_frames, table.data_ptr(), weights.data_ptr(), lo.data_ptr(),
                        start.data_ptr(), weights.numel(), n_mels, out.data_ptr())
    if err:
        raise RuntimeError(f"log10_mel launch failed: cudaError {err}")
    _build.count(log10_mel)
    return out


log10_mel.launches = 0  # kernel launches; only the CUDA branch counts
