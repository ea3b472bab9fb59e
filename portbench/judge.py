"""What decides ``correct``: the served tokens against the plain reference.

The cell's family (``families/<model_type>.py``, its ``judge``) runs its
plain reference once for each judged request, teacher-forced over its
prompt and the tokens the timed path served, and reads two numbers with
the helpers here, the same two for every family:

- ``widest``: at each served position, how far the served token's logit
  lies below the reference's best token that the decode's rules allow
  (``masked``), the widest over every judged token; a served token the
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


@dataclass
class Served:
    """One finished request: its audio, prompt language and served tokens
    (an ending end-of-text token included)."""

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


def masked(logits, first, rest):
    """(n, V) logits with the tokens the rules forbid at each position at -inf."""
    allowed = rest.expand(len(logits), -1).clone()
    allowed[0] = first
    return torch.where(allowed, logits, -math.inf)


def gaps_below_best(masked_ref, pick):
    """How far each picked token's logit lies below the best, (n,)."""
    return masked_ref.amax(dim=-1) - masked_ref.gather(1, pick[:, None])[:, 0]


def mean_logprob(masked_logits, tokens) -> float:
    return float(torch.log_softmax(masked_logits, dim=-1).gather(1, tokens[:, None]).mean())
