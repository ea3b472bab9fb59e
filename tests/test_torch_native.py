"""The port's bridge to the native IO library (``whisper_tpu_torch/utils/
native.py``) against ``whisper_tpu/utils/native.py`` and the numpy
versions, as ``tests/test_native.py`` holds the JAX one: WAV parse, stereo
PCM16, resampling, edit distance, the error path, and ``load_audio`` /
``edit_distance`` through the library against the JAX package's.

The library is built from ``cpp/`` with cmake into this test's own
directory (two test processes building ``cpp/build/`` at once could race)
and named by ``WHISPER_TPU_NATIVE_LIB`` for both packages; without cmake
the test uses ``cpp/build/`` where a library is there and skips
otherwise."""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

from whisper_tpu.eval import wer as jax_wer
from whisper_tpu.ops import audio as jax_audio
from whisper_tpu.utils import native as jax_native
from whisper_tpu_torch.eval import wer as port_wer
from whisper_tpu_torch.ops import audio as port_audio
from whisper_tpu_torch.utils import native as port_native

CPP_DIR = os.path.join(os.path.dirname(__file__), "..", "cpp")
LIB = os.path.join(CPP_DIR, "build", "libwhisper_tpu.so")


def _clear():
    jax_native.load_native.cache_clear()
    port_native.load_native.cache_clear()


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    if shutil.which("cmake") is None:
        if not os.path.exists(LIB):
            pytest.skip("no cmake toolchain")
        path = LIB
    else:
        out = tmp_path_factory.mktemp("native")
        subprocess.run(["cmake", "-S", CPP_DIR, "-B", str(out), "-DCMAKE_BUILD_TYPE=Release"],
                       check=True, capture_output=True, timeout=300)
        subprocess.run(["make", "-C", str(out), "-j4", "whisper_tpu"], check=True,
                       capture_output=True, timeout=300)
        path = str(out / "libwhisper_tpu.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WHISPER_TPU_NATIVE_LIB", path)
        _clear()
        if port_native.load_native() is None:
            pytest.skip("native lib failed to load")
        yield path
    _clear()


def _wav_bytes(x: np.ndarray, rate: int, channels: int = 1, fmt: int = 3) -> bytes:
    if fmt == 3:
        pcm, bits = x.astype("<f4").tobytes(), 32
    else:
        pcm, bits = np.clip(x * 32767, -32768, 32767).astype("<i2").tobytes(), 16
    ba = channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate, rate * ba, ba, bits)
            + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_search_path_is_the_jax_packages():
    """Both look in the same cpp/build/ of this checkout, then the loader's
    path."""
    assert [os.path.realpath(p) for p in port_native._SEARCH[:1]] == [
        os.path.realpath(p) for p in jax_native._SEARCH[:1]] == [os.path.realpath(LIB)]
    assert port_native._SEARCH[1:] == jax_native._SEARCH[1:]


def test_native_wav_parity(native_lib):
    x = (np.random.default_rng(0).standard_normal(4000) * 0.3).astype(np.float32)
    data = _wav_bytes(x, 16000)
    native, rate = port_native.load_wav_native(data, 16000)
    assert rate == 16000
    np.testing.assert_allclose(native, port_audio.to_mono(port_audio.parse_wav(data)[0]),
                               atol=1e-7)
    want, want_rate = jax_native.load_wav_native(data, 16000)
    np.testing.assert_array_equal(native, want)
    assert want_rate == rate


def test_native_wav_pcm16_stereo(native_lib):
    rng = np.random.default_rng(1)
    left, right = (np.clip(rng.standard_normal(1000) * 0.3, -0.99, 0.99).astype(np.float32)
                   for _ in range(2))
    data = _wav_bytes(np.stack([left, right], axis=1).reshape(-1), 16000, channels=2, fmt=1)
    native, _ = port_native.load_wav_native(data, 16000)
    np.testing.assert_allclose(native, (left + right) / 2, atol=2e-4)
    np.testing.assert_array_equal(native, jax_native.load_wav_native(data, 16000)[0])


def test_native_resample_parity(native_lib):
    """The native windowed-sinc resampler against the numpy one on a tone
    (interior samples; the edges differ by boundary handling)."""
    sr0 = 44100
    x = np.sin(2 * np.pi * 440 * np.arange(sr0) / sr0).astype(np.float32)
    data = _wav_bytes(x, sr0)
    native, rate = port_native.load_wav_native(data, 16000)
    ref = port_audio.resample(x, sr0, 16000)
    assert rate == 16000 and len(native) == len(ref)
    np.testing.assert_allclose(native[500:-500], ref[500:-500], atol=5e-3)
    np.testing.assert_array_equal(native, jax_native.load_wav_native(data, 16000)[0])


CASES = [("kitten", "sitting", 3), ("", "abc", 3), ("今天天气", "今天天汽", 1),
         ("甚至出现", "甚至出现", 0), ("abc", "", 3), ("flaw", "lawn", 2)]


@pytest.mark.parametrize("a,b,want", CASES)
def test_native_edit_distance(native_lib, a, b, want):
    assert port_native.edit_distance_native(a, b) == want
    assert port_native.edit_distance_native(a, b) == jax_native.edit_distance_native(a, b)
    assert port_wer._levenshtein(a, b) == want


def test_native_wav_error(native_lib):
    with pytest.raises(ValueError, match="RIFF"):
        port_native.load_wav_native(b"garbage bytes here", 16000)
    with pytest.raises(port_audio.WavFormatError, match="RIFF"):
        port_audio.load_audio(b"garbage bytes here")
    with pytest.raises(jax_audio.WavFormatError, match="RIFF"):
        jax_audio.load_audio(b"garbage bytes here")


def test_load_audio_and_edit_distance_through_native_equal_jax(native_lib, tmp_path):
    """``load_audio`` (path and bytes, 8 kHz stereo PCM16 and 16 kHz float)
    and ``edit_distance`` take the library in both packages and agree."""
    rng = np.random.default_rng(3)
    stereo = np.clip(rng.standard_normal(1600) * 0.2, -1, 1).astype(np.float32)
    for data in (_wav_bytes(stereo, 8000, channels=2, fmt=1),
                 _wav_bytes(stereo[:800], 16000)):
        path = tmp_path / "a.wav"
        path.write_bytes(data)
        got = port_audio.load_audio(str(path))
        np.testing.assert_array_equal(got, jax_audio.load_audio(str(path)))
        np.testing.assert_array_equal(port_audio.load_audio(data), got)
        np.testing.assert_array_equal(got, port_native.load_wav_native(data)[0])
    for a, b, want in CASES:
        assert port_wer.edit_distance(a, b) == jax_wer.edit_distance(a, b) == want


def test_fallback_without_the_library(monkeypatch):
    """With no library to load, ``load_audio`` parses and resamples in numpy
    and ``edit_distance`` runs the Python DP, as the JAX package falls back."""
    monkeypatch.setenv("WHISPER_TPU_NATIVE_LIB", "/nonexistent/libwhisper_tpu.so")
    monkeypatch.setattr(port_native, "_SEARCH", ())
    port_native.load_native.cache_clear()
    try:
        assert not port_native.native_available()
        with pytest.raises(RuntimeError, match="not built"):
            port_native.edit_distance_native("a", "b")
        x = np.clip(np.random.default_rng(4).standard_normal(1600) * 0.2, -1, 1)
        data = _wav_bytes(x, 8000, channels=2, fmt=1)
        chans, rate = port_audio.parse_wav(data)
        np.testing.assert_array_equal(port_audio.load_audio(data),
                                      port_audio.resample(port_audio.to_mono(chans), rate))
        assert port_wer.edit_distance("kitten", "sitting") == 3
    finally:
        port_native.load_native.cache_clear()
