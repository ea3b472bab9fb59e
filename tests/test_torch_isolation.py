"""The port stands alone: no jax, no whisper_tpu, no tiktoken; and its copies
of the JAX package's host-only modules behave the same."""

import ast
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "whisper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "whisper_tpu", "tiktoken", "triton")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_isolation_subprocess():
    """Importing the package, every submodule and chip_smoke loads none of
    the forbidden modules."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import whisper_tpu_torch
for m in pkgutil.walk_packages(whisper_tpu_torch.__path__, "whisper_tpu_torch."):
    importlib.import_module(m.name)
importlib.import_module("chip_smoke")
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in {FORBIDDEN!r})
print("LOADED", bad)
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("module", ["whisper_tpu_torch.ops.int8_gemm",
                                    "whisper_tpu_torch.ops.quantize_rows",
                                    "whisper_tpu_torch.ops.layer_norm_rows",
                                    "whisper_tpu_torch.ops.log10_mel",
                                    "whisper_tpu_torch.formats", "whisper_tpu_torch.longform",
                                    "whisper_tpu_torch.ops.flash_attention",
                                    "whisper_tpu_torch.ops.decode_attention",
                                    "whisper_tpu_torch.models.model", "whisper_tpu_torch.cli",
                                    "whisper_tpu_torch.serving.__main__",
                                    "whisper_tpu_torch.parallel",
                                    "whisper_tpu_torch.parallel.sharding",
                                    "whisper_tpu_torch.parallel.distributed",
                                    "whisper_tpu_torch.models.checkpoint",
                                    "whisper_tpu_torch.eval.quant_gate",
                                    "whisper_tpu_torch.eval.wer",
                                    "whisper_tpu_torch.eval.__main__",
                                    "whisper_tpu_torch.align",
                                    "whisper_tpu_torch.serving.router",
                                    "whisper_tpu_torch.utils.profiling",
                                    "whisper_tpu_torch.utils.logging",
                                    "whisper_tpu_torch.utils.native"])
def test_new_modules_import_alone(module):
    """Each module of the long-form, kernel-selection, tensor-parallel and
    real-weights slices, imported alone, loads none of the forbidden modules (and no
    CUDA toolchain: kernels build at first use)."""
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
importlib.import_module({module!r})
bad = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_statements(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_config_copy_matches():
    from whisper_tpu import config as jc
    from whisper_tpu import tokenizer as jt
    from whisper_tpu_torch import config as tc

    assert tc.PRESETS == jc.PRESETS
    assert tc.LANGUAGES == jt.LANGUAGES and tc.TO_LANGUAGE_CODE == jt.TO_LANGUAGE_CODE
    for name in ("tiny", "turbo", "test-nano"):
        a, b = tc.get_config(name), jc.get_config(name)
        assert a.to_json() == b.to_json()
        assert a.sot_sequence("yue" if a.num_languages == 100 else "zh", "translate") == \
            b.sot_sequence("yue" if b.num_languages == 100 else "zh", "translate")


def test_text_copy_matches():
    from whisper_tpu import text as jt
    from whisper_tpu_torch import text as tt

    assert tt.T2S == jt.T2S and tt.T2S_PHRASES == jt.T2S_PHRASES
    for s, lang in (("乾隆皇帝著名的著作，頭髮", "zh"), (" hello, world ", "en"),
                    ("發展經濟", "yue")):
        assert tt.postprocess(s, lang) == jt.postprocess(s, lang)


def test_longform_copy_matches():
    from whisper_tpu import longform as jl
    from whisper_tpu_torch import longform as tl

    for n in (100, 480000, 480001, 1_000_000):
        assert [(c.start, c.length) for c in tl.plan_chunks(n, overlap_samples=32000)] == \
            [(c.start, c.length) for c in jl.plan_chunks(n, overlap_samples=32000)]
    texts = ["the quick brown fox jumps", "fox jumps over the lazy dog", "", "dog sleeps"]
    for lang in ("en", "zh"):
        assert tl.merge_texts(texts, lang) == jl.merge_texts(texts, lang)


def test_audio_copy_matches(tmp_path):
    from whisper_tpu.ops import audio as ja
    from whisper_tpu_torch.ops import audio as ta

    rng = np.random.default_rng(0)
    stereo = (rng.standard_normal((2, 800)) * 0.2).clip(-1, 1)
    pcm = (stereo.T * 32767).astype("<i2").tobytes()
    wav = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 8000, 8000 * 4, 4, 16)
           + b"data" + struct.pack("<I", len(pcm)) + pcm)
    a, b = ta.parse_wav(wav), ja.parse_wav(wav)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] == 8000
    np.testing.assert_array_equal(ta.resample(ta.to_mono(a[0]), 8000),
                                  ja.resample(ja.to_mono(b[0]), 8000))
    path = tmp_path / "x.wav"
    path.write_bytes(wav)
    # the JAX load_audio itself: both take the native library where it loads
    # (looked for afresh by both), else the numpy branch
    from whisper_tpu.utils import native as jn
    from whisper_tpu_torch.utils import native as tn

    jn.load_native.cache_clear()
    tn.load_native.cache_clear()
    np.testing.assert_array_equal(ta.load_audio(str(path)), ja.load_audio(str(path)))


def test_pcm_copy_matches():
    from whisper_tpu.ops import audio as ja
    from whisper_tpu_torch.ops import audio as ta

    body = np.random.default_rng(1).standard_normal(333).astype("<f4").tobytes()
    np.testing.assert_array_equal(ta.pcm_f32_from_bytes(body), ja.pcm_f32_from_bytes(body))
    for mod in (ta, ja):
        with pytest.raises(mod.WavFormatError):
            mod.pcm_f32_from_bytes(body[:-1])


def test_multipart_copy_matches():
    from whisper_tpu.serving import wire as jw
    from whisper_tpu_torch.serving import wire as tw

    boundary = "XBOUND"
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="language"\r\n\r\n'
        "en\r\n"
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="wav"; filename="a.wav"\r\n'
        "Content-Type: audio/wav\r\n\r\n"
    ).encode() + b"BINARY\x00DATA" + f"\r\n--{boundary}--\r\n".encode()
    for ctype in (f"multipart/form-data; boundary={boundary}",
                  f'multipart/form-data; boundary="{boundary}"'):
        got = tw.parse_multipart(body, ctype)
        assert got == jw.parse_multipart(body, ctype)
        assert got == {"language": "en", "wav": b"BINARY\x00DATA"}
    for mod in (tw, jw):
        with pytest.raises(ValueError):
            mod.parse_multipart(body, "multipart/form-data")


def test_every_kernel_source_is_built():
    """``_build.KERNELS`` names exactly the CUDA sources under csrc/, so
    ``build_all`` (chip_smoke.py, the server's start) builds every kernel."""
    from whisper_tpu_torch.ops import _build

    assert sorted(_build.KERNELS) == sorted(p.stem for p in (PORT / "csrc").glob("*.cu"))
    assert len(set(_build.KERNELS)) == len(_build.KERNELS) == 10
