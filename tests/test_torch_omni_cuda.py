"""Uni-MoE-2.0-Omni's path on the card (marker ``cuda``; skipped
elsewhere): the decode's rounds replayed as CUDA graphs give the bits of
the same rounds run eagerly, and K8 (with K8q for the wide inputs) at the
language model's shapes gives the bits of its plain version; its split-K
schedule, which the decode's products of few rows take, gives the bits of
the persistent schedule and of the plain version, and the published
model's graphed decode launches it 336 times a step (every product of the
28 blocks; the head keeps the persistent tiles). The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_omni_cuda.py
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import get_omni_config
from whisper_tpu_torch.models.omni import init_omni_params, linear
from whisper_tpu_torch.decode import ROUND_STEPS
from whisper_tpu_torch.omni import OmniPipeline, _Loop, _round, greedy
from whisper_tpu_torch.ops import int8_gemm as k8
from whisper_tpu_torch.ops.int8_gemm import (int8_gemm, int8_gemm_plain, int8_gemm_scaled,
                                             int8_gemm_scaled_plain, scale_epilogue)
from whisper_tpu_torch.ops.quant import quantize_weight
from whisper_tpu_torch.ops.quantize_rows import quantize_rows_plain

# the published block at two layers (every width, 7 query heads a KV head,
# the fixed and routed widths, so the routed experts' down projections
# quantize their input in pieces) over tiny's encoder (the encoder kernels take heads of 64)
CARD = dict(audio="tiny", n_layer=2, n_vocab=4096, n_text_ids=4000, stop_id=4095)
# (K, N) of the language model's W8A8 products: q|k|v, o, the fixed experts'
# gate|up and down, a routed expert's gate|up and down, the projector; and
# one KV head group's k or v and one fixed expert's down, as products of
# their own
SHAPES = [(3584, 4608), (3584, 3584), (3584, 9472), (4736, 3584), (3584, 37888),
          (18944, 3584), (1280, 3584), (3584, 512), (2368, 3584)]
# the decode's seven: the first six of SHAPES and the head
DECODE = SHAPES[:6] + [(3584, 152064)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_rounds_equal_eager_rounds(dev):
    cfg = get_omni_config("uni-moe-2.0-omni", **CARD)
    model = init_omni_params(cfg, 0, dev, torch.bfloat16, quantize=True)
    gen = np.random.default_rng(0)
    clips = [gen.standard_normal(16000 * s).astype(np.float32) * 0.1 for s in (30, 12, 30, 5)]
    pipe = OmniPipeline(params=model, compute_dtype="bfloat16", w8a8=True,
                        max_tokens=20, device=dev)
    graphed = []
    for _ in range(2):  # the capture, then a replay
        pipe.transcribe_batch(clips)
        graphed.append(pipe.last_decode)
    assert pipe.graphs.captures == 1 and pipe.graphs.replays > 0
    _, x = pipe.embed_audio(clips)
    loop = _Loop(model, len(clips), 20, torch.bfloat16)
    eager = greedy(model, x, loop, torch.bfloat16,
                   lambda: _round(model, loop, ROUND_STEPS, torch.bfloat16))
    for g in graphed:
        assert torch.equal(g.tokens, eager.tokens) and torch.equal(g.lengths, eager.lengths)
        assert torch.equal(g.avg_logprob, eager.avg_logprob)
        assert (g.steps, g.device_steps) == (eager.steps, eager.device_steps)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [64, 5000])
@pytest.mark.parametrize("K,N", SHAPES + [(3584, 152064)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k8_at_the_language_models_shapes(dev, M, K, N, out):
    if N == 152064 and M > 64:
        pytest.skip("the head runs at the decode's rows and the prompt's last position")
    g = torch.Generator(device=dev).manual_seed(K * N + M)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=dev, generator=g).t()
    sx = torch.rand((M, 1), device=dev, generator=g) * 1e-2
    ws = torch.rand((1, N), device=dev, generator=g) * 1e-2
    bias = torch.randn(N, device=dev, generator=g)
    assert torch.equal(int8_gemm_scaled(a, b, sx, ws, bias, out),
                       int8_gemm_scaled_plain(a, b, sx, ws, bias, out))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [64, 3000])
def test_wide_input_quantized_in_pieces_is_one_product(dev, M):
    """The routed experts' down projection (K 18,944, past K8q's rows): its
    input quantized by K8q in four pieces at the whole row's scale, then one
    K8 product: the bits of the plain product."""
    g = torch.Generator(device=dev).manual_seed(M)
    w = quantize_weight(torch.randn(18944, 3584, device=dev, generator=g) * 0.01, axis=-1)
    x = torch.randn((M, 18944), device=dev, generator=g)
    x8, sx = quantize_rows_plain(x)
    one = scale_epilogue(int8_gemm_plain(x8, w.q), sx, w.s, None, torch.float32)
    w.k_major()
    assert torch.equal(linear(x, w, None, torch.float32), one)


def _operands(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=dev, generator=g).t()
    sx = torch.rand((M, 1), device=dev, generator=g) * 1e-2
    ws = torch.rand((1, N), device=dev, generator=g) * 1e-2
    return a, b, sx, ws, torch.randn(N, device=dev, generator=g)


def _force(monkeypatch, bn, split, M, N):
    """Every product takes the split plan (bn, split), all its tiles at once."""
    ctas = split * -(-M // 64) * -(-N // bn)
    monkeypatch.setattr(k8, "_plan", lambda *shape: k8.SplitPlan(bn, split, ctas))


def _outputs(a, b, sx, ws, bias):
    """int32, and fp32 and bf16 with and without the bias."""
    return [int8_gemm(a, b)] + [int8_gemm_scaled(a, b, sx, ws, bb, out)
                                for out in (torch.float32, torch.bfloat16)
                                for bb in (bias, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 7, 33, 64, 128])
@pytest.mark.parametrize("K,N", DECODE)
def test_split_k8_equals_persistent_and_plain(dev, monkeypatch, M, K, N):
    """At the decode's shapes and up to 128 rows the split schedule (the
    rule's plan, or 192 x 2 where the rule keeps the persistent tiles) gives
    in every output mode the persistent schedule's and the plain version's
    bits; only the rule's split launches count as split."""
    a, b, sx, ws, bias = _operands(dev, M, K, N, K * N + M)
    plan = k8._plan(M, K, N, dev.index or 0)
    before = (int8_gemm.launches, int8_gemm.split_launches)
    _outputs(a, b, sx, ws, bias)
    assert (int8_gemm.launches, int8_gemm.split_launches) == (
        before[0] + 5, before[1] + 5 * (plan is not None))
    if plan is None:
        _force(monkeypatch, 192, 2, M, N)
    split = _outputs(a, b, sx, ws, bias)
    monkeypatch.setattr(k8, "_plan", lambda *shape: None)
    before = int8_gemm.split_launches
    persistent = _outputs(a, b, sx, ws, bias)
    assert int8_gemm.split_launches == before
    acc = int8_gemm_plain(a, b)
    plain = [acc] + [scale_epilogue(acc, sx, ws, bb, out)
                     for out in (torch.float32, torch.bfloat16) for bb in (bias, None)]
    for s_out, p_out, want in zip(split, persistent, plain):
        assert torch.equal(s_out, want) and torch.equal(p_out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(128, 5), (160, 3), (256, 6), (224, 8), (192, 7)],
                         ids=lambda p: f"{p[0]}x{p[1]}")
def test_split_k8_uneven_slices_and_edges(dev, monkeypatch, plan):
    """K slices of unequal length (19 k tiles, the last one 16 bytes, over
    splits that do not divide them), a tile past N, rows past M: forced
    plans give the plain version's bits."""
    M, K, N = 40, 2320, 520
    a, b, sx, ws, bias = _operands(dev, M, K, N, 7)
    _force(monkeypatch, *plan, M, N)
    acc = int8_gemm_plain(a, b)
    plain = [acc] + [scale_epilogue(acc, sx, ws, bb, out)
                     for out in (torch.float32, torch.bfloat16) for bb in (bias, None)]
    for got, want in zip(_outputs(a, b, sx, ws, bias), plain):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(256, 3), (128, 9), (96, 1)], ids=["past_k", "past_8", "bn"])
def test_split_k8_refuses_what_it_cannot_run(dev, monkeypatch, plan):
    """A split past the k tiles (K = 256: two) or past the portable cluster
    of 8, or a tile width it has no kernel for, is refused, not run."""
    a, b, *_ = _operands(dev, 64, 256, 512, 3)
    _force(monkeypatch, *plan, 64, 512)
    before = int8_gemm.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        int8_gemm(a, b)
    assert int8_gemm.launches == before


@pytest.mark.cuda
def test_published_decode_graphed_split_launches(dev):
    """The published language model (28 blocks, the 152,064-id head; tiny's
    encoder): a round of 8 steps captured and replayed gives the ids of the
    same rounds run eagerly, and every round adds 8 x 337 launches of K8,
    8 x 336 of them (all but the head's) on the split schedule."""
    cfg = get_omni_config("uni-moe-2.0-omni", audio="tiny")
    model = init_omni_params(cfg, 0, dev, torch.bfloat16, quantize=True)
    gen = np.random.default_rng(1)
    clips = [gen.standard_normal(16000 * 30).astype(np.float32) * 0.1 for _ in range(64)]
    pipe = OmniPipeline(params=model, compute_dtype="bfloat16", w8a8=True,
                        max_tokens=2 * ROUND_STEPS + 1, device=dev)
    _, x = pipe.embed_audio(clips)
    per_round, split_per_round = 8 * (12 * cfg.n_layer + 1), 8 * 12 * cfg.n_layer
    assert (per_round, split_per_round) == (8 * 337, 8 * 336)
    loop = _Loop(model, len(clips), pipe.max_tokens, torch.bfloat16)
    graphed, rounds = [], []

    def one_round():
        _round(model, loop, ROUND_STEPS, torch.bfloat16)

    def graphed_round():
        before = (int8_gemm.launches, int8_gemm.split_launches)
        pipe.graphs.run(len(clips), one_round)
        rounds.append((int8_gemm.launches - before[0], int8_gemm.split_launches - before[1]))

    for _ in range(2):  # the capture, then replays
        graphed.append(greedy(model, x, loop, torch.bfloat16, graphed_round))
    assert pipe.graphs.captures == 1 and pipe.graphs.replays >= 2
    assert rounds and all(r == (per_round, split_per_round) for r in rounds), rounds
    eager = greedy(model, x, loop, torch.bfloat16, one_round)
    for g in graphed:
        assert torch.equal(g.tokens, eager.tokens) and torch.equal(g.lengths, eager.lengths)
        assert torch.equal(g.avg_logprob, eager.avg_logprob)
