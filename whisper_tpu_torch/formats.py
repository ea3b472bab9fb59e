"""Transcript output writers: txt / json / srt / vtt / tsv.

A copy of ``whisper_tpu/formats.py``: the port keeps its own copy of the
host-side writers. Segments come from timestamp-token decoding
(``--timestamps``) or the seek-based long-form path; when only word timings
exist, segments are synthesized from word groups.

One deliberate difference: a segment that no timestamp closes (end
``None``, which the seek-based path keeps for a window's open last segment)
has no end time to write. json writes ``null``, as the JAX writer does; the
srt, vtt and tsv writers raise a ``ValueError`` that names the segment
(the JAX writers fail on it with a ``TypeError``) rather than invent an
end.
"""

from __future__ import annotations

import io
import json
from types import SimpleNamespace
from typing import IO, List, Optional, Tuple

MAX_SEGMENT_WORDS = 12
MAX_SEGMENT_GAP_S = 1.0


def _fmt_time(t: float, sep: str = ",") -> str:
    ms = int(round(max(t, 0.0) * 1000))
    h, ms = divmod(ms, 3600_000)
    m, ms = divmod(ms, 60_000)
    s, ms = divmod(ms, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def segments_from_words(words: List[dict],
                        language: str = "en") -> List[Tuple[float, float, str]]:
    """Group word timings into subtitle-sized segments.

    Breaks at sentence-final punctuation, at >1 s silences, or every
    MAX_SEGMENT_WORDS words, whichever comes first.
    """
    sep = "" if language in ("zh", "ja", "th", "yue") else " "
    segs: List[Tuple[float, float, str]] = []
    cur: List[dict] = []

    def flush():
        if cur:
            text = sep.join(w["word"].strip() for w in cur).strip()
            if text:
                segs.append((cur[0]["start"], cur[-1]["end"], text))
            cur.clear()

    prev_end: Optional[float] = None
    for w in words:
        if prev_end is not None and w["start"] - prev_end > MAX_SEGMENT_GAP_S:
            flush()
        cur.append(w)
        prev_end = w["end"]
        token = w["word"].strip()
        if len(cur) >= MAX_SEGMENT_WORDS or (
                token and token[-1] in ".。!！?？"):
            flush()
    flush()
    return segs


def _segments(result) -> List[Tuple[float, Optional[float], str]]:
    segs = result.segments
    if not segs and getattr(result, "words", None):
        segs = segments_from_words(result.words, result.language)
    return segs


def _closed_segments(result, fmt: str) -> List[Tuple[float, float, str]]:
    segs = _segments(result)
    for i, (start, end, text) in enumerate(segs):
        if end is None:
            raise ValueError(f"{fmt} needs an end time for every segment; segment {i} "
                             f"(start {start:.2f} s, {text!r}) is open: no timestamp "
                             f"closed it")
    return segs


def write_txt(result, f: IO[str]):
    f.write(result.text + "\n")


def write_json(result, f: IO[str]):
    out = {
        "text": result.text,
        "language": result.language,
        "audio_seconds": result.audio_seconds,
        "rtf": result.rtf,
        "segments": [
            {"start": s, "end": e, "text": t} for s, e, t in _segments(result)
        ],
    }
    if getattr(result, "words", None) is not None:
        out["words"] = result.words
    json.dump(out, f, ensure_ascii=False, indent=2)
    f.write("\n")


def write_srt(result, f: IO[str]):
    for i, (start, end, text) in enumerate(_closed_segments(result, "srt"), 1):
        f.write(f"{i}\n{_fmt_time(start)} --> {_fmt_time(end)}\n{text}\n\n")


def write_vtt(result, f: IO[str]):
    segs = _closed_segments(result, "vtt")
    f.write("WEBVTT\n\n")
    for start, end, text in segs:
        f.write(f"{_fmt_time(start, '.')} --> {_fmt_time(end, '.')}\n{text}\n\n")


def write_tsv(result, f: IO[str]):
    segs = _closed_segments(result, "tsv")
    f.write("start\tend\ttext\n")
    for start, end, text in segs:
        f.write(f"{int(start * 1000)}\t{int(end * 1000)}\t{text}\n")


WRITERS = {
    "txt": write_txt,
    "json": write_json,
    "srt": write_srt,
    "vtt": write_vtt,
    "tsv": write_tsv,
}


def write_result(result, fmt: str, f: IO[str]):
    try:
        writer = WRITERS[fmt]
    except KeyError:
        raise ValueError(
            f"unknown output format {fmt!r}; known: {sorted(WRITERS)}")
    writer(result, f)


# HTTP content types for a server's ``format`` parameter
HTTP_CONTENT_TYPES = {
    "txt": "text/plain; charset=utf-8",
    "srt": "application/x-subrip; charset=utf-8",
    "vtt": "text/vtt; charset=utf-8",
    "tsv": "text/tab-separated-values; charset=utf-8",
    "json": "application/json; charset=utf-8",
}


def render_payload(payload: dict, fmt: str) -> str:
    """Render a serving payload dict (text / language / segments / words
    keys) through the same writers the CLI uses; subtitle formats
    synthesize segments from word timings."""
    ns = SimpleNamespace(
        text=payload.get("text", ""),
        language=payload.get("language") or "en",
        audio_seconds=payload.get("audio_seconds", 0.0),
        rtf=payload.get("rtf", 0.0),
        segments=payload.get("segments") or [],
        words=payload.get("words"),
    )
    buf = io.StringIO()
    write_result(ns, fmt, buf)
    return buf.getvalue()
