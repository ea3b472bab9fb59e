"""The port's transcript writers against the JAX package's, and the CLI's
long-form path on the CPU."""

import io
import json
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from whisper_tpu import formats as jf
from whisper_tpu_torch import cli
from whisper_tpu_torch import formats as tf

SEGMENTS = [(0.0, 2.5, "Hello there."), (2.5, 61.004, "Second, longer segment"),
            (3725.4567, 3726.0, "an hour in: 你好")]
WORDS = [{"word": " Hi", "start": 0.1, "end": 0.4, "probability": 0.9},
         {"word": " there.", "start": 0.5, "end": 0.9, "probability": 0.8},
         {"word": " Later", "start": 2.5, "end": 2.9, "probability": 0.7}]


def _result(segments, words=None, text="Hello there. Second"):
    return SimpleNamespace(text=text, language="en", audio_seconds=3726.5, rtf=0.01,
                           segments=segments, words=words)


@pytest.mark.parametrize("fmt", ["txt", "json", "srt", "vtt", "tsv"])
@pytest.mark.parametrize("source", ["segments", "words"])
def test_writers_equal_jax(fmt, source):
    """Closed segments, or segments synthesized from word timings: the same
    bytes as the JAX writers."""
    r = _result(SEGMENTS) if source == "segments" else _result([], WORDS)
    got, want = io.StringIO(), io.StringIO()
    tf.write_result(r, fmt, got)
    jf.write_result(r, fmt, want)
    assert got.getvalue().encode() == want.getvalue().encode()


def test_render_payload_and_content_types_equal_jax():
    payload = {"text": "hi there", "language": "en", "words": WORDS}
    for fmt in tf.WRITERS:
        assert tf.render_payload(payload, fmt) == jf.render_payload(payload, fmt)
    assert tf.HTTP_CONTENT_TYPES == jf.HTTP_CONTENT_TYPES
    assert tf.segments_from_words(WORDS * 6, "zh") == jf.segments_from_words(WORDS * 6, "zh")
    with pytest.raises(ValueError):
        tf.write_result(_result(SEGMENTS), "docx", io.StringIO())


@pytest.mark.parametrize("fmt", ["srt", "vtt", "tsv"])
def test_open_segment(fmt):
    """A segment no timestamp closed: JAX's subtitle writers fail with a
    TypeError; the port's raise a ValueError naming the segment. json
    writes null for its end on both sides."""
    r = _result(SEGMENTS + [(3726.0, None, "cut off")])
    with pytest.raises(TypeError):
        jf.write_result(r, fmt, io.StringIO())
    with pytest.raises(ValueError, match="segment 3.*cut off"):
        tf.write_result(r, fmt, io.StringIO())
    got, want = io.StringIO(), io.StringIO()
    tf.write_result(r, "json", got)
    jf.write_result(r, "json", want)
    assert got.getvalue() == want.getvalue()
    assert json.loads(got.getvalue())["segments"][-1]["end"] is None


def _wav(path, x):
    pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
                     + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16)
                     + b"data" + struct.pack("<I", len(pcm)) + pcm)


def test_cli_longform_writes_json(tmp_path):
    """--longform --timestamps -f json -o DIR at test-nano on the CPU: one
    parseable file per input with the clip's duration and ordered segments."""
    rng = np.random.default_rng(3)
    paths = []
    for name, secs in (("long", 40), ("short", 4)):
        _wav(tmp_path / f"{name}.wav", rng.standard_normal(16000 * secs) * 0.1)
        paths.append(str(tmp_path / f"{name}.wav"))
    out, report = tmp_path / "out", {}
    rc = cli.main(["--wav", *paths, "--model_type", "test-nano", "--device", "cpu",
                   "--dtype", "float32", "--language", "en", "--max_tokens", "8",
                   "--longform", "--timestamps", "-f", "json", "-o", str(out)], report=report)
    assert rc == 0
    seek = report["pipeline"].last_seek  # the counts of the run the CLI made
    assert seek["rounds"] >= 2 and seek["windows"] >= 3 and report["transcribe_s"] > 0
    for name, secs in (("long", 40), ("short", 4)):
        doc = json.loads((out / f"{name}.json").read_text())
        assert doc["audio_seconds"] == secs and doc["language"] == "en"
        starts = [s["start"] for s in doc["segments"]]
        assert starts == sorted(starts) and all(s >= 0 for s in starts)
        assert all(s["end"] is None or s["end"] >= s["start"] for s in doc["segments"])


def test_cli_defaults_to_the_card():
    args = cli.get_args(["--wav", "x.wav", "--longform", "--timestamps", "-f", "srt"])
    assert args.device == "cuda" and args.longform and args.timestamps
    assert args.output_format == "srt" and not args.no_condition
