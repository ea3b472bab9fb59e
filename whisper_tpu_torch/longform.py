"""Long-audio strategies, ported from ``whisper_tpu/longform.py``.

- Fixed windows (``WhisperPipeline.transcribe_batch``): audio longer than
  one 30 s window is split into overlapping windows that decode as one flat
  batch, and the per-window texts are merged back with the duplicated
  overlap trimmed.
- Seek-based (:func:`transcribe_seek`, ``WhisperPipeline.
  transcribe_longform``): decode a 30 s window with timestamps, advance to
  the end of its last complete segment, repeat.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

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


def _next_pow2(n: int, cap: int = 64) -> int:
    p = 1
    while p < n and p < cap:
        p *= 2
    return p


# previous-text prompt-length buckets: a handful of prompt shapes however
# long the accepted text grows
_PREV_BUCKETS = (16, 64, 223)


def _bucket_prev(n: int) -> int:
    for b in _PREV_BUCKETS:
        if n <= b:
            return b
    return _PREV_BUCKETS[-1]


def _prompts(pipe, live: Sequence[int], texts, bucket: int, sot_seq: np.ndarray):
    """(prompts (bucket, P) int64, prompt_pad (bucket,) or None, sot_index)
    of one round. With condition-on-previous-text (or an initial prompt) row
    j is right-aligned ``[sot_prev, *prev_tokens, sot, lang, task]`` behind
    ``pads[j]`` masked positions; a row without previous text keeps its pad
    pointing at sot, so its whole [sot_prev, prev] region is masked."""
    cfg = pipe.cfg
    max_prev = cfg.n_text_ctx // 2 - 1  # OpenAI's prompt budget
    condition = bool(pipe.condition_on_previous_text)
    initial = (pipe.initial_prompt or "").strip()
    prev_tok = [[] for _ in live]
    if condition or initial:
        for j, i in enumerate(live):
            # the initial prompt seeds the context and fades as transcript
            # accumulates; without conditioning it primes the first window
            # only
            seed = initial if (condition or not texts[i]) else ""
            parts = ([seed] if seed else []) + (texts[i] if condition else [])
            prev = " ".join(parts).strip()
            if prev:
                prev_tok[j] = pipe.tokenizer.encode(" " + prev)[-max_prev:]
    if not any(prev_tok):
        return np.tile(sot_seq[None], (bucket, 1)), None, 0
    prev_w = _bucket_prev(max(len(t) for t in prev_tok))
    P = 1 + prev_w + len(sot_seq)
    prompts = np.full((bucket, P), cfg.eot, np.int64)
    pads = np.full((bucket,), P - len(sot_seq), np.int64)
    prompts[:, -len(sot_seq):] = sot_seq
    for j, t in enumerate(prev_tok):
        if t:
            pads[j] = prev_w - len(t)
            prompts[j, pads[j]] = cfg.sot_prev
            prompts[j, pads[j] + 1: pads[j] + 1 + len(t)] = t
    return prompts, pads, P - len(sot_seq)


def transcribe_seek(pipe, waves: Sequence[np.ndarray], language: str):
    """Timestamp-conditioned sliding-window long-form transcription.

    Each round decodes a 30 s window of every still-live utterance WITH
    timestamps, as one batch padded with empty rows to a power of two, and
    advances each utterance to the end of its window's last complete segment
    (at least 1 s); a window with no complete segment advances a full
    window and keeps its segments, the open last one with end ``None``. A
    window judged silent (``silence_mask``) emits nothing and advances a full
    window. With ``pipe.condition_on_previous_text`` each window's prompt
    carries the accepted text so far (:func:`_prompts`).

    ``pipe`` is a ``WhisperPipeline``. Returns per utterance
    (text, segments [(start_s, end_s or None, text)]). Counts its rounds,
    windows and decoder steps into ``pipe.last_seek``.
    """
    from .decode import extract_texts, greedy_decode
    from .ops.mel import log_mel_batch
    from .text import parse_segments, postprocess

    cfg, dev = pipe.cfg, pipe.device
    n = len(waves)
    seeks = [0] * n
    done = [len(w) == 0 for w in waves]
    segments = [[] for _ in range(n)]
    texts = [[] for _ in range(n)]
    sot_seq = np.asarray(cfg.sot_sequence(language, pipe.task)[:-1], np.int64)  # no notimestamps
    stats = {"rounds": 0, "windows": 0, "steps": 0}

    while not all(done):
        live = [i for i in range(n) if not done[i]]
        bucket = _next_pow2(len(live))
        batch = np.zeros((bucket, N_SAMPLES), np.float32)
        lengths = np.zeros((bucket,), np.int64)
        for j, i in enumerate(live):
            win = waves[i][seeks[i]: seeks[i] + N_SAMPLES]
            batch[j, : len(win)] = win
            lengths[j] = len(win)
        prompts, pads, sot_index = _prompts(pipe, live, texts, bucket, sot_seq)
        mel = log_mel_batch(torch.from_numpy(batch).to(dev), torch.from_numpy(lengths).to(dev),
                            n_mels=cfg.n_mels)[..., : 2 * cfg.n_audio_ctx]
        res = greedy_decode(
            pipe.model, mel, torch.from_numpy(prompts).to(dev), pipe.compute_dtype,
            kv_quant=pipe.kv_quant, w8a8=pipe.w8a8, gelu=pipe.gelu,
            max_tokens=pipe.max_tokens, suppress_ids=pipe._suppress_ids, timestamps=True,
            apply_filters=True, self_kv_quant=pipe.self_kv_quant,
            prompt_pad=None if pads is None else torch.from_numpy(pads).to(dev),
            sot_index=sot_index)
        stats["rounds"] += 1
        stats["windows"] += len(live)
        stats["steps"] += res.steps
        win_texts = extract_texts(res, prompts.shape[1], pipe.tokenizer, timestamps=True)
        silent = silence_mask(res, pipe.no_speech_threshold, pipe.logprob_threshold)
        for j, i in enumerate(live):
            base_s = seeks[i] / 16000.0
            last_window = seeks[i] + int(lengths[j]) >= len(waves[i])
            if silent[j]:
                seeks[i] += N_SAMPLES
                if last_window or seeks[i] >= len(waves[i]):
                    done[i] = True
                continue
            segs = parse_segments(win_texts[j])
            complete = [s for s in segs if s[1] is not None]
            if last_window or not complete:
                # keep everything: done (last window) or a blind full advance
                for s0, s1, txt in segs:
                    segments[i].append((base_s + s0,
                                        base_s + s1 if s1 is not None else None, txt))
                texts[i].append(" ".join(t for _, _, t in segs) if segs else "")
                if last_window:
                    done[i] = True
                else:
                    seeks[i] += N_SAMPLES
            else:
                advance_s = max(complete[-1][1], 1.0)
                for s0, s1, txt in complete:
                    segments[i].append((base_s + s0, base_s + s1, txt))
                texts[i].append(" ".join(t for _, _, t in complete))
                seeks[i] += int(advance_s * 16000)
            if seeks[i] >= len(waves[i]):
                done[i] = True

    pipe.last_seek = stats
    sep = "" if language in ("zh", "ja", "th", "yue") else " "
    return [(postprocess(sep.join(t for t in texts[i] if t), language), segments[i])
            for i in range(n)]
