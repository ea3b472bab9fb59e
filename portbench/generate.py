"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the run's seed in, the run's inputs out.

Audio is seeded white noise at the mix's ``amplitude``, drawn on the device
in one call and handed over as host arrays, as a user hands the port audio.
Where a mix varies sizes (clip lengths, token budgets, arrival gaps), every
seed gets the same set of them, drawn once from the mix's ``sizes_seed``,
in an order drawn from the run's seed: runs differ in content and order,
not in work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

SAMPLE_RATE = 16000


def stream_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's seed (weights, audio,
    order, the sample that is judged)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(1, np.uint64)[0]
               % 2 ** 63)


WEIGHTS, AUDIO, ORDER, SAMPLE = range(4)


def noise(seed: int, lengths: List[int], amplitude: float, device) -> List[np.ndarray]:
    """Clips of white noise of the given sample counts, float32 on the host."""
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, AUDIO))
    flat = torch.randn(sum(lengths), generator=gen, device=device).mul_(amplitude).cpu().numpy()
    return list(np.split(flat, np.cumsum(lengths)[:-1]))


def offline_batches(mix: dict, seed: int, device) -> List[List[np.ndarray]]:
    """``distinct_batches`` batches of ``batch`` clips of ``clip_seconds``."""
    n = int(mix["clip_seconds"] * SAMPLE_RATE)
    clips = noise(seed, [n] * (mix["batch"] * mix["distinct_batches"]), mix["amplitude"], device)
    b = mix["batch"]
    return [clips[i * b: (i + 1) * b] for i in range(mix["distinct_batches"])]


@dataclass
class Arrival:
    due: float          # seconds after the window opens
    samples: int        # clip length
    max_tokens: int     # the request's token budget


def arrivals(mix: dict, seconds: float, seed: int) -> List[Arrival]:
    """An open Poisson schedule at ``rate_per_s`` over ``seconds``: as many
    requests as the rate gives the window, with gaps, clip lengths (uniform
    in ``clip_seconds``) and budgets (the clip's seconds times a rate
    uniform in ``tokens_per_second``, at most ``max_tokens``, at least 1)
    from ``sizes_seed``, each set shuffled by the run's seed."""
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    rng = np.random.default_rng(mix["sizes_seed"])
    gaps = rng.exponential(1.0 / mix["rate_per_s"], n)
    gaps *= seconds / gaps.sum() * (n - 0.5) / n  # the n-th lands inside the window
    lo, hi = mix["clip_seconds"]
    secs = rng.uniform(lo, hi, n)
    rates = rng.uniform(*mix["tokens_per_second"], n)
    order = np.random.default_rng(stream_seed(seed, ORDER))
    gaps, pick = order.permutation(gaps), order.permutation(n)
    dues = np.cumsum(gaps) - gaps[0]
    samples = (secs[pick] * SAMPLE_RATE).astype(np.int64)
    budgets = np.clip((secs * rates)[pick].astype(np.int64), 1, mix["max_tokens"])
    return [Arrival(float(t), int(s), int(m)) for t, s, m in zip(dues, samples, budgets)]
