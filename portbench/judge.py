"""What decides ``correct``: the served tokens against the plain reference.

For each judged request the reference runs once, teacher-forced over its
prompt and the tokens the timed path served, and reads two numbers:

- ``widest``: at each served position, how far the served token's logit
  lies below the reference's best allowed token (``reference.
  allowed_mask``), the widest over every judged token; a served token the
  rules forbid reads as infinitely far. It catches a wrong token.
- ``logprob_error``: the widest difference, over the judged requests,
  between the mean log-probability the program reported for its served
  tokens (``avg_logprob``, under the decode's rules) and the reference's
  of the same tokens under the same rules. It reads the program's
  precision on every request, also where no token lies near a tie.

With a control beside the reference, both are read for the control in the
program's place at the same positions: the gap of the token it puts first,
and its mean log-probability of the served tokens. Beside it, the fault
``a token altered where it is produced`` is read at the same sizes: the
widest gap once the first judged request's first token is moved to the
next token the rules allow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .reference import N_SAMPLES, Reference, Specials, allowed_mask, log_mel
from .weights import Dims, make_weights

ENCODE_BLOCK = 4  # clips the reference encodes at a time


@dataclass
class Served:
    """One finished request: its audio, prompt language and served tokens
    (an ending ``<|endoftext|>`` included)."""

    audio: np.ndarray
    language: str
    tokens: np.ndarray
    avg_logprob: float  # the program's mean log-probability of ``tokens``


@dataclass
class Gaps:
    widest: float        # the widest gap over all judged tokens
    mean: float
    tokens: int          # tokens judged
    logprob_error: float  # the widest |program - reference| mean log-probability
    control: Optional[float] = None  # the control's widest gap, where one ran
    control_logprob_error: Optional[float] = None
    fault: Optional[float] = None  # the widest gap with one served token altered


def sample(finished: Sequence[Served], n: int, seed: int) -> List[Served]:
    """``n`` of ``finished`` drawn from ``seed``, the longest always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i].tokens))
    rest = [i for i in range(len(finished)) if i != longest]
    pick = np.random.default_rng(seed).permutation(rest)[: max(0, n - 1)]
    return [finished[longest]] + [finished[i] for i in sorted(pick)]


def _masked(logits, first, rest):
    """(n, V) logits with the tokens the rules forbid at each position at -inf."""
    allowed = rest.expand(len(logits), -1).clone()
    allowed[0] = first
    return torch.where(allowed, logits, -math.inf)


def _gaps(masked_ref, pick):
    """How far each picked token's logit lies below the best, (n,)."""
    return masked_ref.amax(dim=-1) - masked_ref.gather(1, pick[:, None])[:, 0]


def _mean_logprob(masked, tokens) -> float:
    return float(torch.log_softmax(masked, dim=-1).gather(1, tokens[:, None]).mean())


@torch.no_grad()
def judge(dims: Dims, weight_seed: int, served: Sequence[Served], device,
          control: Optional[str] = None) -> Gaps:
    """The reference's (and, with ``control``, the control's) reading of
    ``served``; weights made again from ``weight_seed`` on ``device``."""
    w = make_weights(dims, weight_seed, device)
    ref = Reference(dims, w)
    ctl = Reference(dims, w, quant=control) if control else None
    sp = Specials(dims)
    first, rest = allowed_mask(dims, device, True), allowed_mask(dims, device, False)
    gaps, ctl_gaps, lp_err, ctl_lp_err, fault = [], [], [], [], []
    for lo in range(0, len(served), ENCODE_BLOCK):
        block = served[lo: lo + ENCODE_BLOCK]
        audio = torch.zeros((len(block), N_SAMPLES), dtype=torch.float32, device=device)
        for i, s in enumerate(block):
            clip = torch.from_numpy(np.ascontiguousarray(s.audio[:N_SAMPLES]))
            audio[i, : len(clip)] = clip.to(device)
        mel = log_mel(audio, [min(len(s.audio), N_SAMPLES) for s in block], dims.n_mels)
        feats = ref.encode(mel)
        ctl_feats = ctl.encode(mel) if ctl else None
        for i, s in enumerate(block):
            if len(s.tokens) == 0:
                continue
            prompt = sp.prompt(s.language)
            toks = torch.as_tensor(np.asarray(s.tokens, np.int64), device=device)
            seq = torch.cat([torch.as_tensor(prompt, device=device), toks[:-1]])[None]
            at = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
            masked = _masked(ref.logits(feats[i: i + 1], seq)[0, at], first, rest)
            gaps.append(_gaps(masked, toks))
            lp_err.append(abs(s.avg_logprob - _mean_logprob(masked, toks)))
            if ctl:
                c = _masked(ctl.logits(ctl_feats[i: i + 1], seq)[0, at], first, rest)
                ctl_gaps.append(_gaps(masked, c.argmax(dim=-1)))
                ctl_lp_err.append(abs(_mean_logprob(c, toks) - _mean_logprob(masked, toks)))
                if not fault:
                    ok = torch.isfinite(masked[0]).nonzero()[:, 0]
                    moved = ok[(ok > toks[0]).nonzero()[0, 0] if (ok > toks[0]).any() else 0]
                    fault.append(float(_gaps(masked[:1], moved[None])[0]))
    if not gaps:
        return Gaps(widest=math.inf, mean=math.inf, tokens=0, logprob_error=math.inf)
    g = torch.cat(gaps)
    return Gaps(widest=float(g.max()), mean=float(g.mean()), tokens=int(g.numel()),
                logprob_error=max(lp_err),
                control=float(torch.cat(ctl_gaps).max()) if ctl_gaps else None,
                control_logprob_error=max(ctl_lp_err) if ctl_lp_err else None,
                fault=max(fault[0], float(g.max())) if fault else None)
