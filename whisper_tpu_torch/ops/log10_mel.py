"""Fused raw log10-mel (K7): framing, Hann-windowed DFT, power, mel
projection and log10 in one pass.

``log10_mel`` is the port of the TPU kernel
``whisper_tpu/ops/mel_pallas.py:log10_mel_pallas`` (``_mel_kernel``):
reflect-padded audio (B, L) fp32 -> raw log10 mel (B, n_mels, n_frames)
fp32, before normalization. On a CUDA tensor it launches the hand-written
Hopper kernel ``whisper_tpu_torch/csrc/log10_mel.cu`` (see the note there);
on a CPU tensor it runs :func:`log10_mel_plain`, the framed-copy and two fp32
matmuls that :func:`~whisper_tpu_torch.ops.mel.log_mel_batch` ran before.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .mel import _dft_bank, _frame, mel_filterbank

N_FFT, HOP = 400, 160  # the only framing the CUDA kernel takes
_PADDED_BINS = 224     # the kernel's bins: 201 padded to 7 per lane


def log10_mel_plain(audio_padded: torch.Tensor, n_mels: int, n_fft: int, hop: int,
                    n_frames: int) -> torch.Tensor:
    """Plain version, all fp32: frames @ windowed DFT bank, |.|^2, mel
    filterbank @ power, log10(max(., 1e-10))."""
    device = audio_padded.device
    frames = _frame(audio_padded.to(torch.float32), n_frames, n_fft, hop)
    spec = torch.matmul(frames, torch.from_numpy(_dft_bank(n_fft)).to(device))  # (B, T, 2F)
    n_freqs = n_fft // 2 + 1
    re, im = spec[..., :n_freqs], spec[..., n_freqs:]
    power = (re * re + im * im).transpose(1, 2)  # (B, F, T)
    mel = torch.matmul(torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(device), power)
    return torch.log10(torch.clamp(mel, min=1e-10))


@functools.lru_cache(maxsize=8)
def _tables(n_mels: int, device: torch.device):
    """The kernel's constant inputs on ``device``: the bank as (400, 224, 2)
    fp32 (cos and -sin per sample and bin, zero past bin 200), the
    filterbank (n_mels, 201) and each filter's nonzero bins [lo, hi)."""
    n_freqs = N_FFT // 2 + 1
    dft = _dft_bank(N_FFT)
    bank = np.zeros((N_FFT, _PADDED_BINS, 2), np.float32)
    bank[:, :n_freqs, 0] = dft[:, :n_freqs]
    bank[:, :n_freqs, 1] = dft[:, n_freqs:]
    fb = mel_filterbank(n_mels, N_FFT)
    lo = np.zeros(n_mels, np.int32)
    hi = np.zeros(n_mels, np.int32)
    for m in range(n_mels):
        nz = np.nonzero(fb[m])[0]
        if len(nz):
            lo[m], hi[m] = nz[0], nz[-1] + 1
    return tuple(torch.from_numpy(a).to(device) for a in (bank, fb, lo, hi))


_SIGNATURE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


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
    bank, fb, lo, hi = _tables(n_mels, audio_padded.device)
    err = _kernel()(audio_padded.data_ptr(), L, B, n_frames, bank.data_ptr(), fb.data_ptr(),
                    lo.data_ptr(), hi.data_ptr(), n_mels, out.data_ptr(),
                    audio_padded.device.index or 0,
                    torch.cuda.current_stream(audio_padded.device).cuda_stream)
    if err:
        raise RuntimeError(f"log10_mel launch failed: cudaError {err}")
    log10_mel.launches += 1
    return out


log10_mel.launches = 0  # kernel launches; only the CUDA branch counts
