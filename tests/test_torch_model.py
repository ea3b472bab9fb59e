"""The port's encoder, cross-KV and decoder against the JAX model in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import quantize_params as jax_qparams
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.params import from_jax_params

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
ATOL = 1e-4  # fp32 end to end; products summed in another order than XLA's


@pytest.fixture(scope="module")
def params():
    jp = jax_qparams(jm.init_params(CFG, jax.random.PRNGKey(0)))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


@pytest.fixture(scope="module")
def fp_params():
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


def _mel(seed=0, B=2):
    return np.random.default_rng(seed).standard_normal(
        (B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def test_encoder_forward_matches_jax(params, monkeypatch):
    """int8 weights, weight-only (JAX reads WHISPER_TPU_W8A8 at trace time;
    encoder_forward is called unjitted so it traces now)."""
    jp, model = params
    monkeypatch.setenv("WHISPER_TPU_W8A8", "0")
    mel = _mel()
    ref = np.asarray(jm.encoder_forward(jp, jnp.asarray(mel), CFG))
    got = tm.encoder_forward(model, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _tie_rows(inputs, eps=3e-5) -> np.ndarray:
    """(B, T) rows where some activation quantized by ``_linear_a8`` has
    x / s_x within ``eps`` of a .5 tie, so that round-off may send the two
    sides to adjacent int8 values."""
    rows = False
    for x in inputs:
        r = (x / (torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-8) / 127.0)).abs()
        rows = rows | ((r - r.floor() - 0.5).abs() < eps).any(-1).numpy()
    return rows


def test_encoder_forward_w8a8_matches_jax(params, monkeypatch):
    """W8A8. One int8 x int8 linear on the same input is bit-exact. Each
    block, fed the JAX block's input, matches the JAX block at 1e-4 on every
    row without a near-tie activation, and sits far closer to it than the
    weight-only block does, so a block that skipped W8A8 would fail. The
    whole encoder is held only to 2% relative L2 and 0.1 abs: where x / s_x
    falls within round-off of a .5 tie the two sides round one activation to
    adjacent int8 values, which moves that token's output row by about
    s_x * s_w * |q_w| (~3e-3 here) and spreads through the next blocks."""
    jp, model = params
    monkeypatch.setenv("WHISPER_TPU_W8A8", "1")
    mel = _mel()
    x = tm.layer_norm(tm.encoder_stem(model, torch.from_numpy(mel)),
                      model.encoder.blocks[0].attn_ln["g"], model.encoder.blocks[0].attn_ln["b"])
    for name in ("wq", "wk", "wv"):
        jw = jax.tree.map(lambda a: a[0], jp["encoder"]["blocks"]["attn"][name])
        ref = np.asarray(jm._linear_a8(jnp.asarray(x.numpy()), jw, None, jnp.float32))
        got = tm._linear_a8(x, model.encoder.blocks[0].attn[name], None, torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref)

    linear_a8, seen = tm._linear_a8, []

    def recording_linear_a8(x, w, b, dtype):
        seen.append(x.detach().float())
        return linear_a8(x, w, b, dtype)

    monkeypatch.setattr(tm, "_linear_a8", recording_linear_a8)
    jx = jm.encoder_stem(jp, jnp.asarray(mel), CFG)
    for l in range(CFG.n_audio_layer):
        x = torch.from_numpy(np.array(jx))
        jx = jm.encoder_blocks(jp, jx, CFG, lo=l, hi=l + 1)
        ref = np.asarray(jx)
        seen.clear()
        got = tm.encoder_blocks(model, x, lo=l, hi=l + 1, w8a8=True).numpy()
        assert len(seen) == 6  # q, k, v, o, mlp1, mlp2 all took the int8 x int8 path
        clean = ~_tie_rows(seen)
        assert clean.mean() > 0.5
        np.testing.assert_allclose(got[clean], ref[clean], rtol=0, atol=ATOL)
        weight_only = tm.encoder_blocks(model, x, lo=l, hi=l + 1).numpy()
        assert 100 * np.abs(got - ref).max() < np.abs(weight_only - ref).max()

    ref = np.asarray(jm.encoder_forward(jp, jnp.asarray(mel), CFG))
    got = tm.encoder_forward(model, torch.from_numpy(mel), w8a8=True).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-2
    assert np.abs(got - ref).max() < 0.1


def test_encoder_fp32_weights_and_stem(fp_params):
    jp, model = fp_params
    mel = _mel(1)
    ref_stem = np.asarray(jm.encoder_stem(jp, jnp.asarray(mel), CFG))
    np.testing.assert_allclose(tm.encoder_stem(model, torch.from_numpy(mel)).numpy(),
                               ref_stem, rtol=0, atol=ATOL)
    ref = np.asarray(jm.encoder_forward(jp, jnp.asarray(mel), CFG))
    got = tm.encoder_forward(model, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    # the layer range split used by segmented encoders composes
    x = tm.encoder_stem(model, torch.from_numpy(mel))
    split = tm.encoder_blocks(model, tm.encoder_blocks(model, x, hi=1), lo=1)
    torch.testing.assert_close(split, tm.encoder_blocks(model, x), rtol=0, atol=0)


def _cross_kv(params, seed=2):
    jp, model = params
    audio = np.random.default_rng(seed).standard_normal(
        (2, CFG.n_audio_ctx, CFG.n_audio_state)).astype(np.float32)
    jkv = jm.compute_cross_kv(jp, jnp.asarray(audio), CFG)
    tkv = tm.compute_cross_kv(model, torch.from_numpy(audio))
    return jkv, tkv


def test_compute_cross_kv_matches_jax(params):
    jkv, tkv = _cross_kv(params)
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == b.shape == (2, 2, 2, CFG.n_audio_ctx, 32)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_quantize_cross_kv_matches_jax(params):
    """Same input -> int8 payloads equal but for a <= 1e-3 share one LSB
    apart (x / s rounded at a .5 boundary), scales to fp32 rounding."""
    jkv, _ = _cross_kv(params)
    ref = jm.quantize_cross_kv(jkv)
    got = tm.quantize_cross_kv(tuple(torch.from_numpy(np.array(a)) for a in jkv))
    for i, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))
        if i % 2 == 0:
            diff = np.abs(a.numpy().astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0)


CASES = [(sq, kq, pad) for sq in (False, True) for kq in (False, True) for pad in (False, True)]


@pytest.mark.parametrize("self_quant,kv_quant,use_pad", CASES,
                         ids=[f"{'qkv' if a else 'kv'}-{'int8x' if b else 'fpx'}-{'pad' if c else 'nopad'}"
                              for a, b, c in CASES])
def test_decoder_forward_prefill_and_step(params, self_quant, kv_quant, use_pad):
    """Prefill of 4 positions, then one S=1 step at offset 4: logits and
    (for the bf16-layout cache) the cache contents match JAX."""
    jp, model = params
    jkv, tkv = _cross_kv(params, seed=3)
    if kv_quant:
        jkv = jm.quantize_cross_kv(jkv)
        tkv = tuple(torch.from_numpy(np.array(a)) for a in jkv)
    B, T = 2, 32
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 50000, (B, 4)).astype(np.int32)
    step = rng.integers(0, 50000, (B, 1)).astype(np.int32)
    pad = np.array([0, 2], np.int32) if use_pad else None

    if self_quant:
        jcache = jm.QKVCache.create(CFG, B, ctx=T)
        tcache = tm.QKVCache.create(PCFG, B, ctx=T, device="cpu")
    else:
        jcache = jm.KVCache.create(CFG, B, ctx=T)
        tcache = tm.KVCache.create(PCFG, B, ctx=T, device="cpu")
    jpad = None if pad is None else jnp.asarray(pad)
    tpad = None if pad is None else torch.from_numpy(pad).long()

    jl1, jcache = jm.decoder_forward(jp, jnp.asarray(prompt), 0, jcache, jkv, CFG, pad=jpad)
    tl1, tcache = tm.decoder_forward(model, torch.from_numpy(prompt).long(), 0, tcache, tkv,
                                     pad=tpad)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=0, atol=ATOL)
    jl2, jcache = jm.decoder_forward(jp, jnp.asarray(step), 4, jcache, jkv, CFG, pad=jpad)
    tl2, tcache = tm.decoder_forward(model, torch.from_numpy(step).long(), 4, tcache, tkv,
                                     pad=tpad)
    assert tl2.shape == (B, 1, CFG.n_vocab)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0, atol=ATOL)
    if not self_quant:
        for a, b in zip(tcache, jcache):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_kv_write_outside_the_cache_raises(params):
    """JAX clamps an out-of-range dynamic_update_slice start; the port
    refuses the write instead of overwriting other positions."""
    _, model = params
    _, tkv = _cross_kv(params)
    cache = tm.KVCache.create(PCFG, 2, ctx=8, device="cpu")
    with pytest.raises(ValueError):
        tm.decoder_forward(model, torch.zeros((2, 2), dtype=torch.long), 7, cache, tkv)


def test_logits_int8_embedding(fp_params):
    """quantize_logits_emb's int8 copy is read by the logits only."""
    from whisper_tpu.ops.quant import quantize_logits_emb as jax_qlogits

    jp = jax_qlogits(fp_params[0])
    model = from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 3, CFG.n_text_state)).astype(np.float32)
    ref = np.asarray(jm._logits(jnp.asarray(x), jp["decoder"], jnp.float32))
    got = tm._logits(torch.from_numpy(x), model.decoder, torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
