"""Long-audio strategies, ported from ``whisper_tpu/longform.py``.

- Fixed windows (``WhisperPipeline.transcribe_batch``): audio longer than
  one 30 s window is split into overlapping windows that decode as one flat
  batch, and the per-window texts are merged back with the duplicated
  overlap trimmed.
- Seek-based (:func:`transcribe_seek`, ``WhisperPipeline.
  transcribe_longform``): decode a 30 s window with timestamps, advance to
  the end of its last complete segment, repeat.
- Served (the engine's requests over 30 s): per-window replies merged by
  :func:`merge_transcripts`, at word level where every window has word
  timings (:func:`merge_window_words`), else by text (:func:`merge_texts`).
"""

from __future__ import annotations

import difflib
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

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
    confident anyway (avg_logprob above ``logprob_threshold``). ``result``
    is a ``GreedyResult`` or a ``beam.BeamResult``."""
    nsp = result.no_speech_prob.cpu().numpy()
    if no_speech_threshold is None:
        return np.zeros(nsp.shape[0], bool)
    silent = nsp > no_speech_threshold
    if logprob_threshold is not None:
        confident = result.avg_logprob.cpu().numpy() > logprob_threshold
        silent &= ~confident
    return silent


def compression_ratio(text: str) -> float:
    """OpenAI's repetition gate: the text's UTF-8 length over its zlib
    length (0 for no text)."""
    raw = text.encode("utf-8")
    return len(raw) / max(len(zlib.compress(raw)), 1)


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


def merge_window_words(window_words: Sequence[Optional[Sequence[dict]]],
                       step_s: float, overlap_s: float) -> List[dict]:
    """Merge per-window word lists (times local to each window, window j
    starting at ``j * step_s``) into one absolute, time-ordered list.

    Each overlap is cut at its midpoint on word start times: window j-1 owns
    the words starting before the cut, window j those at or after it. Where
    one side of an overlap heard nothing (a silence-gated window), the other
    side's words there are kept. A word heard by both windows within 0.3 s
    of the same start is emitted once.
    """
    n = len(window_words)
    wins: List[List[dict]] = []
    for j in range(n):
        ws = window_words[j] or []
        wins.append(sorted(
            (dict(w, start=round(w["start"] + j * step_s, 3),
                  end=round(w["end"] + j * step_s, 3)) for w in ws),
            key=lambda w: (w["start"], w["end"])))
    cuts = [j * step_s + overlap_s / 2.0 for j in range(1, n)]

    def lo(j):
        return cuts[j - 1] if j > 0 else float("-inf")

    def hi(j):
        return cuts[j] if j < n - 1 else float("inf")

    out: List[dict] = []
    for j in range(n):
        for w in wins[j]:
            if lo(j) <= w["start"] < hi(j):
                out.append(w)
            elif w["start"] < lo(j) and not any(
                    x["start"] >= (j - 1) * step_s for x in wins[j - 1]):
                out.append(w)  # window j-1 heard nothing in the shared overlap
            elif (w["start"] >= hi(j) and j + 1 < n
                    and not any(x["start"] < hi(j) + overlap_s / 2.0 for x in wins[j + 1])):
                out.append(w)  # nor window j+1 in its half
    out.sort(key=lambda w: (w["start"], w["end"]))
    deduped: List[dict] = []
    for w in out:
        if (deduped and w["word"].strip() == deduped[-1]["word"].strip()
                and abs(w["start"] - deduped[-1]["start"]) < 0.3):
            continue  # one word heard on both sides of the cut
        deduped.append(w)
    return deduped


def text_from_words(words: Sequence[dict], language: str) -> str:
    """The transcript a merged word list spells, so a long reply's text and
    words agree."""
    text = "".join(w["word"] for w in words).strip()
    if language in ("zh", "ja", "th", "yue"):
        text = text.replace(" ", "")
    return text


def merge_transcripts(results: Sequence[dict], step_s: float, overlap_s: float,
                      language: str) -> dict:
    """Merge per-window replies (``{"text", "words"?}``) into ``{"text",
    "words"?}``: at word level (:func:`merge_window_words`, the text spelled
    from the merged words) when every window has a word list, else by text
    (:func:`merge_texts`)."""
    have_words = [r.get("words") for r in results]
    if all(w is not None for w in have_words):
        words = merge_window_words(have_words, step_s, overlap_s)
        return {"text": text_from_words(words, language), "words": words}
    return {"text": merge_texts([r.get("text", "") for r in results], language)}


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
    carries the accepted text so far (:func:`_prompts`). With
    ``pipe.beam_size > 1`` each round decodes by beam search, as in the JAX
    package.

    ``pipe`` is a ``WhisperPipeline``. Returns per utterance
    (text, segments [(start_s, end_s or None, text)]). Counts its rounds,
    windows and decoder steps (the loops' trip counts, and the steps the
    device ran) into ``pipe.last_seek``.
    """
    from .beam import beam_search
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
    stats = {"rounds": 0, "windows": 0, "steps": 0, "device_steps": 0}

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
        kw = dict(kv_quant=pipe.kv_quant, w8a8=pipe.w8a8, gelu=pipe.gelu,
                  encoder_attention=pipe.encoder_attention, max_tokens=pipe.max_tokens,
                  suppress_ids=pipe._suppress_ids, timestamps=True, apply_filters=True,
                  self_kv_quant=pipe.self_kv_quant,
                  prompt_pad=None if pads is None else torch.from_numpy(pads).to(dev),
                  sot_index=sot_index)
        prompt_t = torch.from_numpy(prompts).to(dev)
        if pipe.beam_size and pipe.beam_size > 1:
            res = beam_search(pipe.model, mel, prompt_t, pipe.compute_dtype,
                              beam_size=pipe.beam_size, **kw)
        else:
            res = greedy_decode(pipe.model, mel, prompt_t, pipe.compute_dtype,
                                cross_decode=pipe.cross_decode, **kw)
        stats["rounds"] += 1
        stats["windows"] += len(live)
        stats["steps"] += res.steps
        stats["device_steps"] += res.device_steps
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
