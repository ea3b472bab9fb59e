"""Uni-MoE-2.0-Omni's path on the card (marker ``cuda``; skipped
elsewhere): the decode's rounds replayed as CUDA graphs give the bits of
the same rounds run eagerly, and K8 (with K8q for the wide inputs) at the
language model's shapes gives the bits of its plain version. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_omni_cuda.py
"""

import numpy as np
import pytest
import torch

from whisper_tpu_torch.config import get_omni_config
from whisper_tpu_torch.models.omni import init_omni_params, linear
from whisper_tpu_torch.decode import ROUND_STEPS
from whisper_tpu_torch.omni import OmniPipeline, _Loop, _round, greedy
from whisper_tpu_torch.ops.int8_gemm import (int8_gemm_plain, int8_gemm_scaled,
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
