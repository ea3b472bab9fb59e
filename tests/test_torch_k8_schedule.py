"""K8's schedule rule (``ops/int8_gemm.split_plan``) and its counter, on the
CPU: which products split K across a cluster, how the plan fills the
card's waves, and ``int8_gemm.split_launches`` through graph replays. No
kernel runs here; the card tests hold the split schedule's bits
(``tests/test_torch_omni_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch

from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops.int8_gemm import (MIN_SLICE, SPLIT_MAX, SPLIT_WIDTHS, int8_gemm,
                                             int8_gemm_scaled, split_plan)
from whisper_tpu_torch.utils.graphs import GraphSet

# CTAs that an H100 SXM (132 SMs) runs at once in clusters of 1, 2, ..., 8
# of the split kernel, one CTA an SM (cudaOccupancyMaxActiveClusters x the
# cluster's size, the card's answer to ``int8_gemm._waves``): its GPCs hold
# fewer clusters of 3 to 8 than 132 / size
H100_WAVES = (132, 132, 117, 120, 110, 102, 105, 120)
# Uni-MoE-2.0-Omni's decode products (K, N): q|k|v, o, the fixed experts'
# gate|up and down, a routed expert's gate|up and down, the head
DECODE = [(3584, 4608), (3584, 3584), (3584, 9472), (4736, 3584), (3584, 37888),
          (18944, 3584), (3584, 152064)]
# Whisper large's encoder (turbo, large-v3, the omni encoder) and a tensor-
# parallel rank's halves of it
WHISPER = [(1280, 1280), (1280, 5120), (5120, 1280), (1280, 640), (640, 1280),
           (1280, 2560), (2560, 1280)]
HEAD = (3584, 152064)  # the head: 594 persistent tiles, 4.5 waves
SPLITS = ([(M, K, N) for K, N in DECODE if (K, N) != HEAD for M in (1, 7, 33, 64)]
          + [(128, K, N) for K, N in DECODE[:4] + DECODE[5:6]]
          + [(64, 16, 8), (64, 256, 512)])  # one k tile, two: clusters of one
PERSISTENT = ([(M, K, N) for K, N in WHISPER for M in (1500, 3000, 12000, 96000)]
              + [(12800, 1280, 3584)]  # the omni projector: 64 clips x 200 tokens
              + [(M, K, N) for K, N in DECODE[:6] for M in (4000, 14848)]  # the prefill
              + [(129, 3584, 3584)]  # past the split's rows
              # the head, whose persistent tiles fill 4.5 waves, and the routed
              # gate|up at 128 rows, whose split tiles would take three rounds
              # of 192 columns against the persistent tiles' two of 256
              + [(M, *HEAD) for M in (1, 7, 33, 64, 128)] + [(128, 3584, 37888)])
CASES = [(*shape, True) for shape in SPLITS] + [(*shape, False) for shape in PERSISTENT]


@pytest.mark.parametrize("M,K,N,splits", CASES,
                         ids=[f"{M}x{K}x{N}" for M, K, N, _ in CASES])
def test_split_rule(M, K, N, splits):
    """Products of at most 128 rows split where the plan's busiest CTA
    streams less weight than the persistent tiles' does, each K slice of at
    least ``MIN_SLICE`` k tiles (or one slice); at up to 64 rows (the
    decode's batch and fewer) the omni decode's clusters fill at least 90%
    of the card's cluster slots in their last round. Whisper's encoder, the
    omni projector and prefill, and the head keep the persistent tiles."""
    plan = split_plan(M, K, N, H100_WAVES)
    assert (plan is not None) == splits
    if plan is None:
        return
    assert plan.bn in SPLIT_WIDTHS and 1 <= plan.split <= SPLIT_MAX
    assert plan.split == 1 or -(-K // 128) // plan.split >= MIN_SLICE
    tiles = -(-M // 64) * -(-N // plan.bn)
    at_once = H100_WAVES[plan.split - 1] // plan.split
    assert plan.ctas == plan.split * min(tiles, at_once)
    if M <= 64 and (K, N) in DECODE:
        assert tiles / (-(-tiles // at_once) * at_once) >= 0.9, plan


class _Counting(GraphSet):
    """A capture that runs the callable's Python (launching nothing) and a
    replay that runs nothing."""

    def _warm(self, fn):
        fn()

    def _capture(self, fn):
        fn()
        return SimpleNamespace(replay=lambda: None)


def test_split_launches_count_through_replays(monkeypatch):
    """``split_launches`` counts beside ``launches``: the warm run counts
    once, the capture on its tally, every replay adds both; a CPU product
    counts neither."""
    monkeypatch.setattr(int8_gemm, "launches", 0)
    monkeypatch.setattr(int8_gemm, "split_launches", 0)

    def round_():
        _build.count(int8_gemm, 3)
        _build.count(int8_gemm, 2, attr="split_launches")

    gs = _Counting("cpu")
    for _ in range(3):
        gs.run("round", round_)
    assert (int8_gemm.launches, int8_gemm.split_launches) == (9, 6)
    assert gs._graphs["round"][1] == [(int8_gemm, 3), ((int8_gemm, "split_launches"), 2)]
    a, b = torch.ones((64, 256), dtype=torch.int8), torch.ones((256, 512), dtype=torch.int8)
    int8_gemm_scaled(a, b, torch.ones((64, 1)), torch.ones(512))
    assert (int8_gemm.launches, int8_gemm.split_launches) == (9, 6)
