"""WER evaluation harness: datasets, edit distance, batched eval loop.

Port of ``whisper_tpu/eval/wer.py``: AIShell (``<utt> <transcript>`` lines)
and CommonVoice (TSV) dataset iterators, character-level edit distance after
punctuation stripping (or word level for spaced languages), and per-utterance
and total WER accumulated as errors over reference units, with the whole
dataset transcribed in batches through the port's pipeline.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

from ..text import remove_punctuation, remove_punctuation_keep_spaces

logger = logging.getLogger("whisper_tpu_torch.wer")


@dataclass
class Utterance:
    path: str
    transcript: str


class AIShellDataset:
    """Ground-truth file of ``<utt_id> <transcript>`` lines; the WAVs are
    ``<utt_id>.wav`` in ``wav_dir`` (default: ``aishell_S0764/`` beside the
    file)."""

    def __init__(self, gt_path: str, wav_dir: Optional[str] = None):
        self.items: List[Utterance] = []
        base = wav_dir or os.path.join(os.path.dirname(gt_path), "aishell_S0764")
        with open(gt_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if len(parts) != 2:
                    continue
                utt, gt = parts
                wav = utt if utt.endswith(".wav") else utt + ".wav"
                self.items.append(Utterance(os.path.join(base, wav), gt))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Utterance]:
        return iter(self.items)


class CommonVoiceDataset:
    """CommonVoice TSV with ``path`` and ``sentence`` columns; the clips are
    in ``clips_dir`` (default: ``clips/`` beside the file)."""

    def __init__(self, tsv_path: str, clips_dir: Optional[str] = None):
        self.items: List[Utterance] = []
        base = clips_dir or os.path.join(os.path.dirname(tsv_path), "clips")
        with open(tsv_path, "r", encoding="utf-8") as f:
            header = f.readline().rstrip("\n").split("\t")
            try:
                pi, si = header.index("path"), header.index("sentence")
            except ValueError:
                raise ValueError(f"TSV missing path/sentence columns: {header}") from None
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) <= max(pi, si):
                    continue
                self.items.append(Utterance(os.path.join(base, cols[pi]), cols[si]))

    def __len__(self):
        return len(self.items)

    def __iter__(self) -> Iterator[Utterance]:
        return iter(self.items)


def _levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance over two sequences with an O(min(m, n)) rolling
    row."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    if not hyp:
        return len(ref)
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (r != h))
        prev = cur
    return prev[-1]


def edit_distance(ref: str, hyp: str) -> int:
    """Levenshtein distance over characters: the native library's where it
    loads (``utils/native.py``), else :func:`_levenshtein`."""
    try:
        from ..utils.native import edit_distance_native, load_native

        if load_native() is not None:
            return edit_distance_native(ref, hyp)
    except Exception:
        pass
    return _levenshtein(ref, hyp)


@dataclass
class WerResult:
    total_errors: int
    total_chars: int
    per_utt: List[Tuple[str, str, str, float]]  # (path, gt, hyp, wer)

    @property
    def wer(self) -> float:
        return self.total_errors / max(self.total_chars, 1)


def score_pairs(pairs: Sequence[Tuple[str, str, str]], level: str = "char") -> WerResult:
    """pairs: (path, ground truth, hypothesis). ``level='char'`` is the zh
    metric (sum of errors over sum of characters); ``level='word'`` is
    whitespace-token WER for spaced languages."""
    total_err = 0
    total_units = 0
    per_utt = []
    for path, gt, hyp in pairs:
        if level == "word":
            gt_u = remove_punctuation_keep_spaces(gt).split()
            err = _levenshtein(gt_u, remove_punctuation_keep_spaces(hyp).split())
        else:
            gt_u = remove_punctuation(gt)
            err = edit_distance(gt_u, remove_punctuation(hyp))
        total_err += err
        total_units += len(gt_u)
        per_utt.append((path, gt, hyp, err / max(len(gt_u), 1)))
    return WerResult(total_err, total_units, per_utt)


def evaluate(
    pipeline,
    dataset,
    batch_size: int = 8,
    language: Optional[str] = "zh",
    limit: Optional[int] = None,
    log_path: Optional[str] = None,
    level: str = "char",
) -> WerResult:
    """Batched WER over ``dataset`` with ``pipeline.transcribe_batch``
    (``language=None`` detects it); per-utterance lines and the total go to
    the ``whisper_tpu_torch.wer`` logger, and to ``log_path`` if given."""
    items = list(dataset)[:limit]
    pairs: List[Tuple[str, str, str]] = []
    handler = None
    prev_level = logger.level
    if log_path:
        handler = logging.FileHandler(log_path)
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)  # the file gets every line, whatever the root level
    try:
        for i in range(0, len(items), batch_size):
            chunk = items[i: i + batch_size]
            results = pipeline.transcribe_batch([u.path for u in chunk], language=language)
            for u, r in zip(chunk, results):
                pairs.append((u.path, u.transcript, r.text))
                part = score_pairs(pairs[-1:], level=level)
                logger.info("(%d/%d) %s gt: %s predict: %s WER: %.2f%%",
                            len(pairs), len(items), os.path.basename(u.path),
                            u.transcript, r.text, 100 * part.wer)
        res = score_pairs(pairs, level=level)
        logger.info("Total WER: %.4f (%d/%d chars)", res.wer, res.total_errors, res.total_chars)
        return res
    finally:
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()
            logger.setLevel(prev_level)
