"""Fixed-window long-audio helpers used by ``WhisperPipeline.transcribe_batch``.

Copied from ``whisper_tpu/longform.py``: audio longer than one 30 s window is
split into overlapping windows that decode as one flat batch, and the
per-window texts are merged back with the duplicated overlap trimmed. The
seek-based long-form path (``transcribe_seek``) is not ported yet.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .config import N_SAMPLES


@dataclass
class ChunkSpec:
    start: int  # sample offset into the utterance
    length: int


def plan_chunks(n_samples: int, chunk_samples: int = N_SAMPLES,
                overlap_samples: int = 0) -> List[ChunkSpec]:
    """Split an utterance into fixed windows (last one may be short)."""
    if n_samples <= chunk_samples:
        return [ChunkSpec(0, n_samples)]
    step = chunk_samples - overlap_samples
    if step <= 0:
        raise ValueError("overlap must be smaller than the chunk")
    out = []
    pos = 0
    while pos < n_samples:
        ln = min(chunk_samples, n_samples - pos)
        out.append(ChunkSpec(pos, ln))
        if pos + ln >= n_samples:
            break
        pos += step
    return out


def split_audio(audio: np.ndarray, chunk_samples: int = N_SAMPLES,
                overlap_samples: int = 0) -> Tuple[List[np.ndarray], List[ChunkSpec]]:
    specs = plan_chunks(len(audio), chunk_samples, overlap_samples)
    return [audio[s.start : s.start + s.length] for s in specs], specs


def _lcs_overlap(a: str, b: str, max_probe: int = 40) -> int:
    """Length of the longest suffix of `a` that prefixes `b` (merge trim)."""
    limit = min(len(a), len(b), max_probe)
    for ln in range(limit, 0, -1):
        if a[-ln:] == b[:ln]:
            return ln
    return 0


def _fuzzy_overlap(a: str, b: str, max_probe: int = 48,
                   similarity: float = 0.72) -> int:
    """Chars to drop from the head of ``b`` that re-hear the tail of ``a``:
    the largest junction-anchored window pair (a's tail, b's head) whose
    difflib similarity reaches ``similarity``, else the exact overlap."""
    exact = _lcs_overlap(a, b, max_probe)
    limit = min(len(a), len(b), max_probe)
    for j in range(limit, max(3, exact), -1):
        r = difflib.SequenceMatcher(None, a[len(a) - j:], b[:j],
                                    autojunk=False).ratio()
        if r >= similarity:
            return j
    return exact


def silence_mask(result, no_speech_threshold, logprob_threshold) -> np.ndarray:
    """OpenAI no-speech gate: a window is silent when its no-speech
    probability exceeds ``no_speech_threshold``, unless the decode was
    confident anyway (avg_logprob above ``logprob_threshold``)."""
    nsp = result.no_speech_prob.cpu().numpy()
    if no_speech_threshold is None:
        return np.zeros(nsp.shape[0], bool)
    silent = nsp > no_speech_threshold
    if logprob_threshold is not None:
        confident = result.avg_logprob.cpu().numpy() > logprob_threshold
        silent &= ~confident
    return silent


def merge_texts(texts: Sequence[str], language: str = "zh",
                trim_overlap: bool = True, max_probe: int = 48,
                similarity: float = 0.72) -> str:
    """Concatenate chunk transcripts, trimming text duplicated by the audio
    overlap (fuzzy junction match, :func:`_fuzzy_overlap`)."""
    sep = "" if language in ("zh", "ja", "th", "yue") else " "
    out = ""
    for t in texts:
        t = t.strip()
        if not t:
            continue
        if out and trim_overlap:
            ln = _fuzzy_overlap(out, t, max_probe=max_probe,
                                similarity=similarity)
            t = t[ln:].strip()
        if not t:
            continue
        out = out + sep + t if out else t
    return out
