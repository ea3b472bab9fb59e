"""ctypes bridge to the repository's native IO library
(``cpp/build/libwhisper_tpu.so``, built by ``cpp/build.sh``).

Port of ``whisper_tpu/utils/native.py``: the same library, found the same
way (``WHISPER_TPU_NATIVE_LIB``, then ``cpp/build/`` of this checkout, then
the loader's search path), for the WAV parse with its windowed-sinc
resampler and the edit distance. ``ops/audio.load_audio`` and
``eval/wer.edit_distance`` use it when it loads and their numpy and Python
versions otherwise, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

_SEARCH = (
    os.path.join(os.path.dirname(__file__), "..", "..", "cpp", "build", "libwhisper_tpu.so"),
    "libwhisper_tpu.so",
)


@functools.lru_cache(maxsize=1)
def load_native() -> Optional[ctypes.CDLL]:
    """The library with its signatures declared, or None where none loads."""
    path = os.environ.get("WHISPER_TPU_NATIVE_LIB")
    for c in ([path] if path else []) + list(_SEARCH):
        try:
            lib = ctypes.CDLL(c)
        except OSError:
            continue
        lib.wt_load_wav.restype = ctypes.c_int
        lib.wt_load_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.wt_resample.restype = ctypes.c_int
        lib.wt_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.wt_edit_distance.restype = ctypes.c_int64
        lib.wt_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ]
        lib.wt_free.argtypes = [ctypes.c_void_p]
        lib.wt_last_error.restype = ctypes.c_char_p
        return lib
    return None


def native_available() -> bool:
    return load_native() is not None


def load_wav_native(data: bytes, target_rate: int = 16000) -> Tuple[np.ndarray, int]:
    """Parse a WAV byte string, downmix to mono and resample to
    ``target_rate``: (float32 samples, rate). Raises RuntimeError without
    the library and ValueError (the library's message) on a bad file."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native lib not built")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rate = ctypes.c_int()
    rc = lib.wt_load_wav(data, len(data), target_rate,
                         ctypes.byref(out), ctypes.byref(n), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(lib.wt_last_error().decode())
    try:
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.wt_free(out)
    return arr, rate.value


def edit_distance_native(a: str, b: str) -> int:
    """Levenshtein distance over the code points of ``a`` and ``b``."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native lib not built")
    aa = np.frombuffer(a.encode("utf-32-le"), dtype=np.uint32)
    bb = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    pa = aa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    pb = bb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    return int(lib.wt_edit_distance(pa, len(aa), pb, len(bb)))
