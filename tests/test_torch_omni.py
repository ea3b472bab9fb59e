"""Uni-MoE-2.0-Omni on the port (``models/omni.py``, ``omni.py``) against the
benchmark's plain fp32 reference (``portbench/omni_reference.py``), on the
CPU at the tiny size that keeps the published ratios (``test-omni``): the
prefill and the cached decode against the reference's full forward pass,
the router's rule, the decode's all-rows experts against the prefill's
gathered ones, and the W8A8 path against the judge's limits with the int4
control beside it."""

import contextlib
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import generate, judge
from portbench.families import grin_qwen2_vl as family
from portbench.harness import checks_of, is_correct
from portbench.omni_reference import OmniReference, draw, prompt_ids
from portbench.tests import omni_tiny
from whisper_tpu_torch.config import get_omni_config
from whisper_tpu_torch.models import omni as omni_model
from whisper_tpu_torch.models.omni import (
    build_omni,
    linear,
    moe,
    moe_stats,
    new_cache,
    prefill,
    reset_moe_stats,
    route,
    step,
    weight_shapes,
)
from whisper_tpu_torch.ops.int8_gemm import int8_gemm_plain, scale_epilogue
from whisper_tpu_torch.ops.quant import quantize_weight
from whisper_tpu_torch.ops.quantize_rows import quantize_rows_plain
from whisper_tpu_torch.omni import OmniPipeline

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
# fp32 on both sides; they differ in summation order only (SDPA and the
# cached step against one causal softmax over the whole sequence, the
# fixed experts as one product of their summed width against two): ~1e-6 of
# logits of a few units, so 1e-4 leaves room, while a bf16 cast anywhere
# on the path moves them by ~1e-2
LOGIT_TOL = 1e-4


def _dims():
    return family.dims(omni_tiny.cell().config)


def _model(quantize=False, seed=SEED):
    d = _dims()
    cfg = family.port_config(d, "tiny-omni")
    return d, build_omni(cfg, lambda name, shape: draw(seed, name, shape, CPU), CPU,
                         quantize=quantize)


@contextlib.contextmanager
def _routes():
    """Each router call's chosen sets (N, E) bool, in call order."""
    got = []

    def recording(p, top_p, top_k):
        got.append(route(p, top_p, top_k))
        return got[-1]

    with mock.patch.object(omni_model, "route", recording):
        yield got


def _clips(n=3, seed=5):
    lengths = [generate.SAMPLE_RATE * s for s in (30, 7, 19)[:n]]
    return generate.noise(seed, lengths, 0.1, CPU)


@torch.no_grad()
def test_fp32_prefill_and_cached_decode_match_the_reference():
    d, model = _model()
    prefix, suffix = prompt_ids(d, SEED)
    pipe = OmniPipeline(params=model, prefix_ids=prefix, suffix_ids=suffix, max_tokens=6,
                        device="cpu")
    clips = _clips()
    served = [r.tokens for r in pipe.transcribe_batch(clips)]
    assert all(len(t) == 6 for t in served)

    _, x = pipe.embed_audio(clips)
    kv = new_cache(model, len(clips), 128, torch.float32)
    ref_rec = []
    toks = torch.as_tensor(np.stack(served))
    with _routes() as port_rec:
        logits = [prefill(model, x, kv, torch.float32)]
        for i in range(5):
            logits.append(step(model, toks[:, i], torch.tensor(d.prompt_len + i), kv,
                               torch.float32))
    port = torch.stack(logits, dim=1)
    ref = torch.stack(OmniReference(d, SEED, CPU).logits(clips, prefix, suffix, served,
                                                         record=ref_rec))
    assert (port - ref).abs().max() < LOGIT_TOL
    assert (port.argmax(-1) == toks).all()  # the served ids are the reference's greedy ones

    B, P, L, S = len(clips), d.prompt_len, d.n_layer, d.prompt_len + 5
    for layer in range(L):
        full = ref_rec[layer].view(B, S, -1)
        assert torch.equal(port_rec[layer].view(B, P, -1), full[:, :P])
        for i in range(5):
            assert torch.equal(port_rec[L + i * L + layer], full[:, P + i])


@pytest.mark.parametrize("p,chosen", [
    ([0.75, 0.10, 0.05, 0.05, 0.05], [1, 0, 0, 0, 0]),   # the top at 0.7 or more: one
    ([0.70, 0.20, 0.05, 0.03, 0.02], [1, 0, 0, 0, 0]),   # exactly 0.7 reaches it
    ([0.05, 0.40, 0.35, 0.10, 0.10], [0, 1, 1, 0, 0]),   # two reach it
    ([0.30, 0.25, 0.20, 0.15, 0.10], [1, 1, 0, 0, 0]),   # two do not: capped at two
    ([0.10, 0.05, 0.05, 0.20, 0.60], [0, 0, 0, 1, 1]),   # the null expert among them
    ([0.02, 0.03, 0.05, 0.10, 0.80], [0, 0, 0, 0, 1]),   # the null expert alone
    ([0.30, 0.30, 0.30, 0.05, 0.05], [1, 1, 0, 0, 0]),   # a tie goes to the lower index
], ids=["one", "one-at-0.7", "two", "capped", "with-null", "null-alone", "tie"])
def test_top_p_rule(p, chosen):
    got = route(torch.tensor([p]), 0.7, 2)[0]
    assert got.tolist() == [bool(c) for c in chosen]
    assert got.sum() <= 2


def test_null_expert_adds_nothing():
    """A row that chooses only the null expert gets the fixed experts alone."""
    d, model = _model()
    layer = model.layers[0]
    m = layer.moe
    gate = m["gate"]
    x = torch.randn(1, d.d_model, generator=torch.Generator().manual_seed(6))
    m["gate"] = torch.zeros_like(gate)
    m["gate"][:, -1] = 100.0 * torch.sign(x[0] * m["norm"])  # the null expert's logit >> 0
    try:
        with _routes() as rec:
            out = moe(model, layer, x, torch.float32)
        assert rec[0].tolist() == [[False] * d.n_routed + [True]]
        routed = m["routed"]
        m["routed"] = []
        fixed_only = moe(model, layer, x, torch.float32)
        m["routed"] = routed
    finally:
        m["gate"] = gate
    assert torch.equal(out, fixed_only)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "w8a8"])
def test_all_rows_form_equals_gathered_form(quantize):
    d, model = _model(quantize)
    x = torch.randn(64, d.d_model, generator=torch.Generator().manual_seed(3)) * 3.0
    with _routes() as rec:
        for layer in model.layers:
            gathered = moe(model, layer, x, torch.float32)
            all_rows = moe(model, layer, x, torch.float32, all_rows=True)
            assert torch.equal(gathered, all_rows)
    assert rec[0][:, : d.n_routed].any(0).all()  # every routed expert was chosen by some row


def test_wide_w8a8_input_quantized_in_pieces_is_one_product():
    """A W8A8 product whose input is wider than K8q takes, its rows
    quantized in pieces at the whole row's scale, gives the bits of one."""
    g = torch.Generator().manual_seed(4)
    w = quantize_weight(torch.randn(18944, 96, generator=g) * 0.01, axis=-1)
    x = torch.randn(5, 18944, generator=g)
    x8, sx = quantize_rows_plain(x)
    one = scale_epilogue(int8_gemm_plain(x8, w.q), sx, w.s, None, torch.float32)
    assert torch.equal(linear(x, w, None, torch.float32), one)


def test_moe_stats_count_every_decision():
    d, model = _model(quantize=True)
    prefix, suffix = prompt_ids(d, SEED)
    pipe = OmniPipeline(params=model, prefix_ids=prefix, suffix_ids=suffix, max_tokens=10,
                        device="cpu", w8a8=True)
    reset_moe_stats(model)
    pipe.transcribe_batch(_clips(2))
    s = moe_stats(model)
    assert s["prefill"]["decisions"] == d.n_layer * 2 * d.prompt_len
    assert s["decode"]["decisions"] == d.n_layer * 2 * pipe.last_decode.steps
    for phase in s.values():
        n = phase["decisions"]
        assert 0 < phase["one_expert_share"] < 1 and 0 < phase["null_share"] < 1
        assert phase["one_expert_share"] + phase["two_expert_share"] == pytest.approx(1.0)
        assert sum(phase["routed_tokens"]) + phase["null_tokens"] == \
            n * (phase["one_expert_share"] + 2 * phase["two_expert_share"])
    assert pipe.last_decode.device_steps == 16 and pipe.last_decode.host_syncs == 2


@pytest.mark.parametrize("seed", [1, 2])
def test_w8a8_within_the_limits_and_the_int4_control_not(seed):
    """The W8A8 path (the CPU's plain K8q and K8) is correct by the tiny
    cell's limits, read by the family's judge, and the int4 control in its
    place is not."""
    cell = omni_tiny.cell(dict(compute_dtype="float32", w8a8=True))
    d = cell.family.dims(cell.config)
    wseed = generate.stream_seed(seed, generate.WEIGHTS)
    prefix, suffix = prompt_ids(d, wseed)
    pipe = OmniPipeline(params=family.port_model(d, cell.config, wseed, CPU), prefix_ids=prefix,
                        suffix_ids=suffix, max_tokens=10, device="cpu", w8a8=True)
    clips = _clips(3, seed)
    served = [judge.Served(audio=c, language="", tokens=r.tokens, avg_logprob=r.avg_logprob)
              for c, r in zip(clips, pipe.transcribe_batch(clips))]
    gaps = family.judge(d, wseed, served, CPU, control="int4")
    program = checks_of(cell.limits, gaps.widest, gaps.logprob_error, 0)
    ctl = checks_of(cell.limits, gaps.control, gaps.control_logprob_error, 0)
    assert is_correct(program, gaps.tokens), program
    assert not is_correct(ctl, gaps.tokens), ctl


def test_published_preset_sizes():
    """The preset holds the published widths and depth: 26.8 B parameters."""
    cfg = get_omni_config("uni-moe-2.0-omni")
    n = {name: int(np.prod(shape)) for name, shape in weight_shapes(cfg)}
    layer = sum(v for k, v in n.items() if k.startswith("layers.0."))
    assert (cfg.d_model, cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim) == \
        (3584, 28, 28, 4, 128)
    assert (cfg.d_fixed, cfg.d_routed, cfg.n_vocab, cfg.prompt_len) == (2368, 18944, 152064, 232)
    assert 894e6 < layer < 896e6
    assert 26.7e9 < sum(n.values()) < 26.9e9


def test_pipeline_refusals():
    d, model = _model(quantize=True)
    with pytest.raises(ValueError, match="pass w8a8=True"):
        OmniPipeline(params=model, device="cpu")
    with pytest.raises(ValueError, match="max_tokens"):
        OmniPipeline("test-omni", device="cpu", max_tokens=2048)
    pipe = OmniPipeline("test-omni", device="cpu", max_tokens=4)
    with pytest.raises(ValueError, match="30 s"):
        pipe.transcribe_batch([np.zeros(16000 * 31, np.float32)])


def test_config_file_holds_the_catalog_numbers():
    """Every number of the published configuration is in the cell's file,
    unchanged, beside what it assumes."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    c = json.load(open(os.path.join(root, "portbench", "configs", "uni-moe-2.0-omni.json")))
    assert c["model_type"] == "grin_qwen2_vl" and c["reduced"] == []
    d = family.dims(c)
    assert (d.d_model, d.n_layer, d.n_routed, d.n_null, d.n_fixed, d.top_k) == \
        (3584, 28, 4, 1, 2, 2)
    assert d.whisper.n_audio_state == 1280 and d.n_query == 200
