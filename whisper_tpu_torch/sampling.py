"""Logit filtering rules for decoding: suppression + timestamp grammar.

Port of ``whisper_tpu/sampling.py``: the OpenAI-Whisper rule set as batched
transforms over (N, V) logits, driven by O(1) per-stream state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import WhisperConfig

NEG_INF = -1e30


def build_suppress_ids(cfg: WhisperConfig, tokenizer=None,
                       suppress_nonspeech: bool = True) -> np.ndarray:
    """Token ids always suppressed during sampling (OpenAI defaults): the
    special-token family and, given a tokenizer, its non-speech symbols."""
    ids = {cfg.transcribe, cfg.translate, cfg.sot, cfg.sot_prev, cfg.sot_lm,
           cfg.no_speech}
    ids.update(cfg.lang_token_start + i for i in range(cfg.num_languages))
    if suppress_nonspeech and tokenizer is not None:
        ids.update(tokenizer.non_speech_tokens)
    ids.discard(cfg.eot)
    return np.asarray(sorted(ids), np.int32)


class RuleState(NamedTuple):
    """Per-stream incremental state for the rules. All (N,) int64."""

    last: torch.Tensor       # previous sampled token
    penult: torch.Tensor     # token before that
    max_ts: torch.Tensor     # highest timestamp token emitted so far (or 0)
    n_sampled: torch.Tensor  # tokens sampled after the prompt

    @classmethod
    def create(cls, n: int, device="cpu") -> "RuleState":
        def full(v):
            return torch.full((n,), v, dtype=torch.int64, device=device)

        return cls(full(-1), full(-1), full(0), full(0))

    def advance(self, sampled: torch.Tensor, timestamp_begin: int) -> "RuleState":
        sampled = sampled.to(torch.int64)
        return RuleState(
            last=sampled,
            penult=self.last,
            max_ts=torch.where(sampled >= timestamp_begin,
                               torch.maximum(self.max_ts, sampled), self.max_ts),
            n_sampled=self.n_sampled + 1,
        )


def apply_rules(
    logits: torch.Tensor,  # (N, V) fp32
    state: RuleState,
    cfg: WhisperConfig,
    suppress_ids: Optional[torch.Tensor] = None,
    timestamps: bool = False,
    max_initial_timestamp_index: Optional[int] = 50,  # 1.0 s, OpenAI default
) -> torch.Tensor:
    """Return filtered logits (a new tensor)."""
    N, V = logits.shape
    vocab = torch.arange(V, device=logits.device)[None, :]
    ts0 = cfg.timestamp_begin
    eot = cfg.eot
    neg = torch.tensor(NEG_INF, dtype=logits.dtype, device=logits.device)

    logits = logits.clone()
    if suppress_ids is not None:
        logits[:, suppress_ids] = NEG_INF
    logits[:, cfg.no_timestamps] = NEG_INF  # never a valid sample

    first = (state.n_sampled == 0)[:, None]
    blank = (vocab == cfg.blank_id) | (vocab == eot)
    logits = torch.where(first & blank, neg, logits)

    if not timestamps:
        return torch.where(vocab >= ts0, neg, logits)

    is_ts = vocab >= ts0
    is_text = vocab < eot
    last_was_ts = (state.last >= ts0)[:, None]
    penult_was_ts = ((state.penult >= ts0) | (state.penult < 0))[:, None]

    # pairs rule: [ts, ts] -> must be text; [text, ts] -> must be ts or eot
    logits = torch.where(last_was_ts & penult_was_ts & is_ts, neg, logits)
    logits = torch.where(last_was_ts & ~penult_was_ts & is_text, neg, logits)

    # monotonicity: no timestamp below the running max (equal allowed to
    # close a pair)
    floor = torch.where((state.last >= ts0) & (state.penult < ts0) & (state.penult >= 0),
                        state.max_ts, state.max_ts + 1)
    floor = torch.clamp(floor, min=ts0)
    logits = torch.where(is_ts & (vocab < floor[:, None]), neg, logits)

    # the first sampled token is a timestamp, capped at the initial maximum
    logits = torch.where(first & ~is_ts, neg, logits)
    if max_initial_timestamp_index is not None:
        cap = ts0 + max_initial_timestamp_index
        logits = torch.where(first & is_ts & (vocab > cap), neg, logits)

    # a timestamp is forced when their total mass beats every text token
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts, logprobs, neg), dim=-1)
    text_max = torch.where(~is_ts, logprobs, neg).amax(dim=-1)
    force_ts = (ts_mass > text_max)[:, None]
    return torch.where(force_ts & ~is_ts, neg, logits)
