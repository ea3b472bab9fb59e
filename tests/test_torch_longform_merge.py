"""The merge of a long request's windows in the port
(``whisper_tpu_torch.longform``: ``merge_window_words``, ``text_from_words``,
``merge_transcripts``) against the JAX package's: the contracts of
``tests/test_longform.py`` and seeded random word lists, equal outputs."""

import numpy as np
import pytest

from whisper_tpu import longform as jl
from whisper_tpu_torch import longform as tl


def _w(word, start, end):
    return {"word": word, "start": start, "end": end}


def test_merge_window_words_midpoint_cut_and_straddle():
    step, ov = 28.0, 2.0  # windows [0, 30), [28, 58); the cut at 29.0
    w0 = [_w(" a", 1.0, 2.0), _w(" cut", 0.9 + 28, 1.4 + 28)]
    w1 = [_w(" cut", 1.05, 1.5), _w(" tail", 4.0, 5.0)]  # "cut" heard again
    out = tl.merge_window_words([w0, w1], step, ov)
    assert [w["word"].strip() for w in out] == ["a", "cut", "tail"]
    assert [w["start"] for w in out] == sorted(w["start"] for w in out)
    assert out[-1]["start"] == 32.0  # window 1's words shifted by the step
    assert out == jl.merge_window_words([w0, w1], step, ov)


def test_merge_window_words_straddler_single_emission():
    step, ov = 28.0, 2.0
    w0 = [_w(" strad", 28.9, 29.6)]
    w1 = [_w(" strad", 1.1, 1.8)]  # 29.1 absolute: the other side of the cut
    out = tl.merge_window_words([w0, w1], step, ov)
    assert len(out) == 1 and out == jl.merge_window_words([w0, w1], step, ov)


def test_merge_window_words_silent_window_fallback():
    step, ov = 28.0, 2.0
    w1 = [_w(" early", 0.2, 0.8), _w(" late", 3.0, 4.0)]  # window 0 silence-gated
    out = tl.merge_window_words([[], w1], step, ov)
    assert [w["word"].strip() for w in out] == ["early", "late"] and out[0]["start"] == 28.2
    assert out == jl.merge_window_words([None, w1], step, ov) == \
        tl.merge_window_words([None, w1], step, ov)


def test_merge_transcripts_words_and_text_agree():
    step, ov = 28.0, 2.0
    results = [{"text": "hello there", "words": [_w(" hello", 1.0, 1.5), _w(" there", 2.0, 2.5)]},
               {"text": "again", "words": [_w(" again", 3.0, 3.6)]}]
    m = tl.merge_transcripts(results, step, ov, "en")
    assert m["text"] == "hello there again"
    assert "".join(w["word"] for w in m["words"]).strip() == m["text"]
    assert m == jl.merge_transcripts(results, step, ov, "en")
    # without words on every window: the text fallback, no words key
    fallback = [{"text": "hello there"}, {"text": "there again", "words": []}]
    m2 = tl.merge_transcripts(fallback, step, ov, "en")
    assert m2 == {"text": "hello there again"} == jl.merge_transcripts(fallback, step, ov, "en")


@pytest.mark.parametrize("language", ["en", "zh"])
def test_text_from_words_equals_jax(language):
    words = [_w(" 你", 0.0, 0.2), _w("好", 0.2, 0.4), _w(" world", 0.5, 0.9)]
    assert tl.text_from_words(words, language) == jl.text_from_words(words, language)


def _random_windows(rng, n, step, ov):
    """Per-window word lists in window-local times: words from a shared
    timeline, each window hearing its span (overlaps heard twice, with
    jitter), some windows silent (None or [])."""
    timeline = np.sort(rng.uniform(0, step * (n - 1) + 30.0, 6 * n))
    vocab = ["alpha", "beta", "gamma", "delta", "eps", "zeta"]
    wins = []
    for j in range(n):
        lo, hi = j * step, j * step + 30.0
        if rng.random() < 0.2:
            wins.append(None if rng.random() < 0.5 else [])
            continue
        ws = []
        for k, t in enumerate(timeline):
            if lo <= t < hi:
                s = float(t - lo + rng.uniform(-0.2, 0.2))
                ws.append(_w(" " + vocab[k % len(vocab)], round(s, 3),
                             round(s + float(rng.uniform(0.1, 0.6)), 3)))
        wins.append(ws)
    return wins


@pytest.mark.parametrize("seed", range(6))
def test_merge_equals_jax_on_random_windows(seed):
    """Seeded word lists over 2-5 windows at 0-5 s overlaps: the merged
    words, the text they spell and the text fallback equal JAX's."""
    rng = np.random.default_rng(seed)
    n, ov = int(rng.integers(2, 6)), float(rng.choice([0.0, 2.0, 5.0]))
    step = 30.0 - ov
    wins = _random_windows(rng, n, step, ov)
    assert tl.merge_window_words(wins, step, ov) == jl.merge_window_words(wins, step, ov)
    lang = "zh" if seed % 2 else "en"
    results = [{"text": " ".join(w["word"].strip() for w in (ws or []))}
               | ({} if ws is None else {"words": ws}) for ws in wins]
    assert tl.merge_transcripts(results, step, ov, lang) == \
        jl.merge_transcripts(results, step, ov, lang)
    with_words = [dict(r, words=r.get("words") or []) for r in results]
    assert tl.merge_transcripts(with_words, step, ov, lang) == \
        jl.merge_transcripts(with_words, step, ov, lang)
