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
from whisper_tpu_torch.ops.layer_norm_rows import layer_norm_rows
from whisper_tpu_torch.ops.quantize_rows import quantize_rows_plain
from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
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

    quantize_rows, gemm_scaled, seen, products = tm.quantize_rows, tm.int8_gemm_scaled, [], []
    norm_rows = tm.layer_norm_rows

    def recording_quantize_rows(x, sx=None):
        seen.append(x.detach().float().reshape(2, CFG.n_audio_ctx, -1))
        return quantize_rows(x, sx)

    def recording_layer_norm_rows(x, g, b):
        # the LayerNorm output these int8 rows quantize
        seen.append(tm.layer_norm(x, g, b).detach().float().reshape(2, CFG.n_audio_ctx, -1))
        return norm_rows(x, g, b)

    def counting_gemm_scaled(*args):
        products.append(args[1].shape)
        return gemm_scaled(*args)

    monkeypatch.setattr(tm, "quantize_rows", recording_quantize_rows)
    monkeypatch.setattr(tm, "int8_gemm_scaled", counting_gemm_scaled)
    monkeypatch.setattr(tm, "layer_norm_rows", recording_layer_norm_rows)
    jx = jm.encoder_stem(jp, jnp.asarray(mel), CFG)
    for l in range(CFG.n_audio_layer):
        x = torch.from_numpy(np.array(jx))
        jx = jm.encoder_blocks(jp, jx, CFG, lo=l, hi=l + 1)
        ref = np.asarray(jx)
        seen.clear()
        products.clear()
        got = tm.encoder_blocks(model, x, lo=l, hi=l + 1, w8a8=True).numpy()
        # q, k, v, o, mlp1, mlp2 all took the int8 x int8 path; q, k and v
        # share one quantization of their LayerNorm output (the two
        # LayerNorms' through layer_norm_rows, o's and mlp2's inputs through
        # quantize_rows)
        assert len(products) == 6 and len(seen) == 4
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


def test_encoder_stem_writes_contiguous_rows(fp_params):
    """The stem's output is a contiguous (B, T, D), with the values of the
    conv's transposed layout plus the positional embedding."""
    _, model = fp_params
    mel = torch.from_numpy(_mel(3))
    got = tm.encoder_stem(model, mel)
    assert got.is_contiguous() and got.shape == (2, CFG.n_audio_ctx, CFG.n_audio_state)
    enc = model.encoder
    x = tm._gelu(torch.nn.functional.conv1d(mel, enc.conv1["w"], enc.conv1["b"], padding=1))
    x = tm._gelu(torch.nn.functional.conv1d(x, enc.conv2["w"], enc.conv2["b"], stride=2,
                                            padding=1)).transpose(1, 2)
    assert torch.equal(got, x + enc.pos_emb[: x.shape[1]])


@pytest.mark.parametrize("ranks", [1, 2])
def test_column_quantizes_once_for_q_k_v(params, monkeypatch, ranks):
    """Under W8A8 ``_column`` quantizes the shared LayerNorm output once per
    rank for the q, k and v products, with the bits of three separate
    ``_linear_a8`` calls."""
    _, model = params
    attn = model.encoder.blocks[0].attn
    pairs = [(attn["wq"], attn["bq"]), (attn["wk"], None), (attn["wv"], attn["bv"])]
    h = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 30, CFG.n_audio_state)).astype(np.float32))
    want = [tm._linear_a8(h, w, b, torch.float32) for w, b in pairs]
    quantize_rows, calls = tm.quantize_rows, []

    def counting(x, sx=None):
        calls.append(x.shape)
        return quantize_rows(x, sx)

    monkeypatch.setattr(tm, "quantize_rows", counting)
    got = tm._column(h, [pairs] * ranks, torch.float32, a8=True)
    assert calls == [(60, CFG.n_audio_state)] * ranks
    for rank in got:
        assert len(rank) == 3
        for g, w in zip(rank, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [64, 1280])
def test_layer_norm_rows_on_the_cpu_is_the_plain_version(dtype, D):
    """On the CPU the K8n wrapper is ``layer_norm`` then
    ``quantize_rows_plain``, bit for bit, and launches nothing."""
    rng = np.random.default_rng(D)
    x, g, b = (torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (
        rng.standard_normal((7, D)) * 3 + 1, rng.standard_normal(D), rng.standard_normal(D)))
    before = layer_norm_rows.launches
    q, sx = layer_norm_rows(x, g, b)
    want_q, want_sx = quantize_rows_plain(tm.layer_norm(x, g, b))
    assert q.dtype == torch.int8 and torch.equal(q, want_q) and torch.equal(sx, want_sx)
    assert layer_norm_rows.launches == before


@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "weight_only"])
@pytest.mark.parametrize("ranks", [1, 2])
def test_encoder_blocks_fuse_layer_norm_under_w8a8(params, monkeypatch, w8a8, ranks):
    """``encoder_blocks`` under W8A8 calls the K8n wrapper twice a block on
    all of the batch's rows, once for every rank of a mesh, and gives the
    bits of the unfused encoder (``layer_norm`` then :func:`_column`, which
    quantizes on every rank); without W8A8 it never calls it."""
    _, model = params
    if ranks > 1:
        model = shard_params(model, make_mesh(1, ranks, devices=["cpu"] * ranks))
    x = tm.encoder_stem(model, torch.from_numpy(_mel(4)))
    calls = []

    def spy(rows, g, b):
        calls.append(tuple(rows.shape))
        return layer_norm_rows(rows, g, b)

    monkeypatch.setattr(tm, "layer_norm_rows", spy)
    got = tm.encoder_blocks(model, x, w8a8=w8a8)
    rows = (2 * CFG.n_audio_ctx, CFG.n_audio_state)
    assert calls == ([rows] * 2 * CFG.n_audio_layer if w8a8 else [])
    monkeypatch.setattr(tm, "_norm_column", lambda h, ln, per_rank, dtype, a8=False: tm._column(
        tm.layer_norm(h, ln["g"], ln["b"]), per_rank, dtype, a8))
    assert torch.equal(got, tm.encoder_blocks(model, x, w8a8=w8a8))


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


def _seeded_caches(self_quant, B, T, seed=6):
    """The same random cache contents on both sides (JAX, port)."""
    rng = np.random.default_rng(seed)
    L, H, dh = CFG.n_text_layer, CFG.n_text_head, CFG.head_dim_text
    if self_quant:
        q = rng.integers(-127, 128, (L, B, H, 2, dh, T)).astype(np.int8)
        s = rng.uniform(0.005, 0.02, (L, B, H, 2, T)).astype(np.float32)
        return (jm.QKVCache(jnp.asarray(q), jnp.asarray(s)),
                tm.QKVCache(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))
    k, v = (rng.standard_normal((L, B, H, dh, T)).astype(np.float32) for _ in range(2))
    return (jm.KVCache(jnp.asarray(k), jnp.asarray(v)),
            tm.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _near_ties(kh, vh, eps=1e-5) -> np.ndarray:
    """(B, H, 2, dh) bool: x / s within ``eps`` of a .5 tie in
    quantize_kv_heads for a (B, H, 1, dh) step input."""
    x = torch.stack([kh, vh], dim=2).to(torch.float32)[..., 0, :]  # (B, H, 2, dh)
    r = (x / (torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-12) / 127.0)).abs().numpy()
    return np.abs(r - np.floor(r) - 0.5) < eps


MULTIPOS = [(sq, kq) for sq in (False, True) for kq in (False, True)]


@pytest.mark.parametrize("self_quant,kv_quant", MULTIPOS,
                         ids=[f"{'qkv' if a else 'kv'}-{'int8x' if b else 'fpx'}"
                              for a, b in MULTIPOS])
@pytest.mark.parametrize("use_pads", [False, True], ids=["nopad", "pad"])
def test_decoder_step_multipos_matches_jax(params, monkeypatch, self_quant, kv_quant, use_pads):
    """One step with every row at its own offset, from the same cache on
    both sides: 0 (one visible key), ragged ones, T-1, and T, whose write
    falls outside the cache and is dropped. Logits within 1e-4. Positions
    not written stay equal; the written float entries (|x| up to ~3) agree
    within 1e-6 + 2e-6 |x|, a few fp32 ulps of summation order through the
    layer below; the written int8 entries are equal but for +-1 where the
    quantizer's x / s sits within 1e-5 of a .5 tie."""
    jp, model = params
    jkv, _ = _cross_kv(params, seed=7)
    if kv_quant:
        jkv = jm.quantize_cross_kv(jkv)
    jkv = tuple(a[:, [0, 1, 0, 1, 0]] for a in jkv)  # 5 rows over the 2 clips
    tkv = tuple(torch.from_numpy(np.array(a)) for a in jkv)
    B, T = 5, 16
    offsets = np.array([0, 3, 9, 15, 16], np.int32)
    pads = np.array([0, 1, 4, 0, 2], np.int32) if use_pads else None
    toks = np.random.default_rng(8).integers(0, 50000, B).astype(np.int32)
    jcache, tcache = _seeded_caches(self_quant, B, T)
    before = [a.numpy().copy() for a in tcache]

    seen = []
    if self_quant:
        real = tm.quantize_kv_heads
        monkeypatch.setattr(tm, "quantize_kv_heads",
                            lambda kh, vh: seen.append((kh, vh)) or real(kh, vh))
    jl, jcache = jm.decoder_step_multipos(jp, jnp.asarray(toks), jnp.asarray(offsets), jcache,
                                          jkv, CFG, pads=None if pads is None else jnp.asarray(pads))
    tl, tcache = tm.decoder_step_multipos(model, torch.from_numpy(toks).long(),
                                          torch.from_numpy(offsets).long(), tcache, tkv,
                                          pads=None if pads is None else torch.from_numpy(pads).long())
    assert tl.shape == (B, CFG.n_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    got = [a.numpy() for a in tcache]
    want = [np.asarray(a) for a in jcache]
    written = np.zeros((B, T), bool)
    written[np.arange(4), offsets[:4]] = True  # row 4's write (at T) is dropped
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(np.moveaxis(g, -1, 2)[:, ~written],
                                      np.moveaxis(b, -1, 2)[:, ~written])
        np.testing.assert_array_equal(np.moveaxis(w, -1, 2)[:, ~written],
                                      np.moveaxis(b, -1, 2)[:, ~written])
    if not self_quant:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6)
        return
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    diff = got[0].astype(np.int32) - want[0].astype(np.int32)
    assert np.abs(diff).max() <= 1
    for layer, (kh, vh) in enumerate(seen):
        d = diff[layer][np.arange(4), ..., offsets[:4]]  # (4, H, 2, dh)
        assert not (d != 0)[~_near_ties(kh, vh)[:4]].any(), f"layer {layer}: +-1 off a tie"
