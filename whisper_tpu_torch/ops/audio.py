"""Host-side audio IO: WAV/PCM parsing, downmix, resampling.

A copy of ``whisper_tpu/ops/audio.py``: the numpy WAV parser, the polyphase
resampler and the raw-PCM wire decoder, and in :func:`load_audio` the
native library's WAV loader (``utils/native.py``) first where it loads, as
in the JAX package.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple, Union

import numpy as np

SAMPLE_RATE = 16000


class WavFormatError(ValueError):
    pass


def parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE byte string -> (float32 samples (channels, n), rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/float64, any channel count.
    """
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise WavFormatError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (csize,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + csize]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            raw = body
        pos += 8 + csize + (csize & 1)
    if fmt is None or raw is None:
        raise WavFormatError("missing fmt/data chunk")
    audio_format, channels, rate, _, block_align, bits = fmt
    if audio_format == 0xFFFE and len(data) >= 24:  # WAVE_FORMAT_EXTENSIBLE
        # sub-format GUID's first two bytes give the real format tag
        try:
            (audio_format,) = struct.unpack_from("<H", data, data.index(b"fmt ") + 8 + 24)
        except Exception:
            raise WavFormatError("unsupported WAVE_FORMAT_EXTENSIBLE")

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
        else:
            raise WavFormatError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise WavFormatError(f"unsupported float bit depth {bits}")
    else:
        raise WavFormatError(f"unsupported WAV format tag {audio_format}")

    n = (len(x) // channels) * channels
    x = x[:n].reshape(-1, channels).T
    return np.ascontiguousarray(x), rate


def write_wav(path: str, samples: np.ndarray, rate: int = SAMPLE_RATE) -> None:
    """Write mono float32 samples as 16-bit PCM WAV."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


def to_mono(x: np.ndarray) -> np.ndarray:
    """(channels, n) -> (n,) mean downmix (cpp/src/api/ax_whisper_api.cpp:109-113)."""
    if x.ndim == 1:
        return x
    return x.mean(axis=0).astype(np.float32)


def resample(x: np.ndarray, orig_sr: int, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase windowed-sinc resampling, mono float32 in/out."""
    if orig_sr == target_sr:
        return np.asarray(x, dtype=np.float32)
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    x = np.asarray(x, dtype=np.float64)
    # upsample by zero-stuffing, lowpass at min(input, output) Nyquist, decimate
    half_zeros = 24
    cutoff = 1.0 / max(up, down)
    half = half_zeros * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = up * cutoff * np.sinc(cutoff * n) * np.blackman(len(n))

    up_len = len(x) * up
    upsampled = np.zeros(up_len, dtype=np.float64)
    upsampled[::up] = x
    y = np.convolve(upsampled, taps, mode="same")
    y = y[::down]
    out_len = int(round(len(x) * target_sr / orig_sr))
    if len(y) < out_len:
        y = np.pad(y, (0, out_len - len(y)))
    return y[:out_len].astype(np.float32)


def load_audio(
    source: Union[str, bytes, np.ndarray],
    sample_rate: int = SAMPLE_RATE,
    orig_sr: Optional[int] = None,
) -> np.ndarray:
    """Load audio from a WAV path/bytes or raw array -> mono float32 @16 kHz.

    Mirrors the reference entrypoints: WAV file (python/whisper.py:126-129,
    cpp/src/api/ax_whisper_api.cpp:88-124) and raw PCM (RunPCM, :139-163).
    WAV bytes go through the native library where it loads (its error on a
    bad file becomes a :class:`WavFormatError`), else the numpy parser and
    resampler.
    """
    if isinstance(source, np.ndarray):
        x = to_mono(np.asarray(source, dtype=np.float32))
        if orig_sr is not None and orig_sr != sample_rate:
            x = resample(x, orig_sr, sample_rate)
        return x
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    try:
        from ..utils.native import load_native, load_wav_native

        if load_native() is not None:
            samples, _ = load_wav_native(data, sample_rate)
            return samples
    except ValueError as e:
        raise WavFormatError(str(e))
    except Exception:
        pass  # fall back to the numpy parser
    chans, rate = parse_wav(data)
    x = to_mono(chans)
    if rate != sample_rate:
        x = resample(x, rate, sample_rate)
    return x


def pcm_f32_from_bytes(body: bytes) -> np.ndarray:
    """Raw little-endian f32 PCM (the C++ server's wire format,
    cpp/src/WhisperHTTPServer.hpp:103-113). Length must be a multiple of 4."""
    if len(body) % 4 != 0:
        raise WavFormatError("PCM byte length must be a multiple of 4")
    return np.frombuffer(body, dtype="<f4").astype(np.float32)
