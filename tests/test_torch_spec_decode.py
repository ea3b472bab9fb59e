"""Speculative decoding of the port against the JAX package (CPU, fp32,
the same bridged weights): ``decoder_window_multipos`` and
``speculative_decode_kv``.

The configurations are ``tests/test_spec_decode.py``'s own (a 2-layer
target, a 1-layer draft of half its width, the same vocabulary), copied
here. Three drafts: a random one of another seed (acceptance 0: the
reject/bonus path), the target itself (every proposal accepted) and the
target with seeded noise of 0.1 of each matrix's spread added (about a
third accepted: the partial path).

Tokens, lengths and ``accepted`` / ``drafted`` / ``rounds`` must be equal;
``no_speech_prob`` within 1e-5; ``avg_logprob`` within 1e-5 with float
caches, and with the int8 ones within the greedy tests' tolerance (rtol
1e-4, atol 1e-5: a cross-KV value at a rounding tie quantizes one level
apart on the two sides). The window is held within 2e-4 (JAX's own
tolerance for it in ``tests/test_spec_decode.py``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import WhisperConfig as JaxConfig
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.models import model as jm
from whisper_tpu.spec_decode import speculative_decode_kv as jax_spec
from whisper_tpu_torch.config import WhisperConfig
from whisper_tpu_torch.decode import encode_cross_kv, greedy_decode_kv
from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.spec_decode import SPEC_ROUNDS, SpecResult, speculative_decode_kv

torch.set_num_threads(2)

NANO_DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=64, n_audio_head=2,
                 n_audio_layer=2, n_vocab=51865, n_text_ctx=32, n_text_state=64,
                 n_text_head=2, n_text_layer=2)
DRAFT_DIMS = dict(n_mels=80, n_audio_ctx=64, n_audio_state=32, n_audio_head=2,
                  n_audio_layer=1, n_vocab=51865, n_text_ctx=32, n_text_state=32,
                  n_text_head=2, n_text_layer=1)
NANO = JaxConfig(name="nano-spec", **NANO_DIMS)
DRAFT = JaxConfig(name="nano-spec-draft", **DRAFT_DIMS)
PNANO = WhisperConfig(name="nano-spec", **NANO_DIMS)
PDRAFT = WhisperConfig(name="nano-spec-draft", **DRAFT_DIMS)
NEAR_NOISE = 0.1


def _bridge(jp, cfg):
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _near(jp):
    """The target's tree with seeded noise of NEAR_NOISE x each matrix's
    spread added (vectors, LayerNorms included, kept)."""
    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda a: (a + NEAR_NOISE * a.std() * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim >= 2 else a, jax.tree.map(np.array, jp))
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """name -> (config, JAX params, the port's model)."""
    target = jm.init_params(NANO, jax.random.PRNGKey(0))
    return {"target": (NANO, *_bridge(target, PNANO)),
            "random": (DRAFT, *_bridge(jm.init_params(DRAFT, jax.random.PRNGKey(7)), PDRAFT)),
            "self": (NANO, *_bridge(target, PNANO)),
            "near": (NANO, *_bridge(_near(target), PNANO))}


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(0).standard_normal(
        (3, NANO.n_mels, 2 * NANO.n_audio_ctx)).astype(np.float32)


def _prompt(cfg, b=3):
    return np.asarray([cfg.sot_sequence("zh", "transcribe")] * b, np.int32)


def _jax_run(models, mel, draft, gamma, max_tokens, quant, cfg=NANO, dcfg=None):
    _, jp, _ = models["target"]
    dcfg_, jd, _ = models[draft]
    m = jnp.asarray(mel)
    return jax_spec(jp, jax_encode_cross_kv(jp, m, cfg, kv_quant=quant), jd,
                    jax_encode_cross_kv(jd, m, dcfg or dcfg_, kv_quant=quant),
                    jnp.asarray(_prompt(cfg)), cfg, dcfg or dcfg_, gamma=gamma,
                    max_tokens=max_tokens, self_kv_quant=quant)


def _port_run(models, mel, draft, gamma, max_tokens, quant):
    _, _, model = models["target"]
    _, _, dmodel = models[draft]
    m = torch.from_numpy(mel)
    return speculative_decode_kv(model, encode_cross_kv(model, m, kv_quant=quant), dmodel,
                                 encode_cross_kv(dmodel, m, kv_quant=quant),
                                 torch.from_numpy(_prompt(NANO)).long(), gamma=gamma,
                                 max_tokens=max_tokens, self_kv_quant=quant)


def _assert_equal_results(got: SpecResult, ref, quant: bool, stats: bool = True):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(ref.avg_logprob),
                               rtol=1e-4 if quant else 0, atol=1e-5)
    if stats:
        assert (int(got.accepted), int(got.drafted), int(got.rounds)) == (
            int(ref.accepted), int(ref.drafted), int(ref.rounds))


# name: (draft, gamma, token budget, int8 cross- and self-KV)
CASES = {
    "random-g1-t12": ("random", 1, 12, False),
    "random-g3-t12": ("random", 3, 12, False),
    "random-g4-t12": ("random", 4, 12, False),
    "random-g4-t1": ("random", 4, 1, False),
    "random-g4-t2": ("random", 4, 2, False),
    "random-g4-t5": ("random", 4, 5, False),
    "random-g2-t10-int8": ("random", 2, 10, True),
    "random-g4-t7-int8": ("random", 4, 7, True),
    "self-g3-t16": ("self", 3, 16, False),
    "self-g4-t11-int8": ("self", 4, 11, True),
    "near-g4-t16": ("near", 4, 16, False),
    "near-g3-t9-int8": ("near", 3, 9, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_decode_matches_jax(models, mel, case):
    """Tokens, lengths and the accept/draft/round counts equal JAX's."""
    draft, gamma, budget, quant = CASES[case]
    ref = _jax_run(models, mel, draft, gamma, budget, quant)
    got = _port_run(models, mel, draft, gamma, budget, quant)
    assert got.tokens.dtype == torch.int64 and got.tokens.shape == (3, NANO.n_text_ctx)
    _assert_equal_results(got, ref, quant)
    # one flag read a group of SPEC_ROUNDS rounds, whole groups on the device
    assert got.host_syncs == max(1, -(-got.rounds // SPEC_ROUNDS))
    assert got.device_rounds == got.host_syncs * SPEC_ROUNDS
    if draft == "random":
        assert int(got.accepted) == 0
    if draft == "self":
        assert int(got.accepted) > 0
        # every proposal accepted but those cut at the budget or an eot
        assert int(got.accepted) >= int(got.drafted) - 2 * got.rounds


def test_spec_decode_acceptance_is_partial_with_the_near_draft(models, mel):
    """The near draft's acceptance lies strictly between 0 and 1, so the
    cut of ``cumprod`` inside a round runs."""
    got = _port_run(models, mel, "near", 4, 16, False)
    assert 0 < int(got.accepted) < int(got.drafted)


@pytest.mark.parametrize("draft,gamma,quant", [("random", 4, False), ("near", 2, False),
                                               ("self", 4, True), ("random", 1, True)])
def test_spec_decode_equals_port_greedy(models, mel, draft, gamma, quant):
    """The exactness invariant against the port's own greedy decode: the
    same tokens and lengths, whatever the draft; the no-speech probability
    is the same prefill's, and the mean log-prob sums the same tokens'."""
    _, _, model = models["target"]
    got = _port_run(models, mel, draft, gamma, 12, quant)
    ref = greedy_decode_kv(model, encode_cross_kv(model, torch.from_numpy(mel), kv_quant=quant),
                           torch.from_numpy(_prompt(NANO)).long(), max_tokens=12,
                           self_kv_quant=quant)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths.numpy())
    np.testing.assert_allclose(got.no_speech_prob.numpy(), ref.no_speech_prob.numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.avg_logprob.numpy(), ref.avg_logprob.numpy(),
                               rtol=1e-4 if quant else 0, atol=1e-5)


@pytest.mark.parametrize("gamma", [1, 4])
def test_spec_decode_at_the_ctx_edge_matches_jax(mel, gamma):
    """``max_tokens=None`` at ``n_text_ctx = 16`` (JAX's ctx-edge test):
    the windows' writes cross the cache's end and are dropped. Tokens and
    lengths equal JAX's and the port's greedy. JAX's draft step fills a
    positional index past the table with NaN (``jnp.take``) where the port
    clips it, so a proposal there can differ and the counts are held only
    at gamma 1, which runs no 1-wide draft step."""
    cfg16 = dataclasses.replace(NANO, name="nano-spec16", n_text_ctx=16)
    d16 = dataclasses.replace(DRAFT, name="nano-draft16", n_text_ctx=16)
    p16 = dataclasses.replace(PNANO, name="nano-spec16", n_text_ctx=16)
    pd16 = dataclasses.replace(PDRAFT, name="nano-draft16", n_text_ctx=16)
    models = {"target": (cfg16, *_bridge(jm.init_params(cfg16, jax.random.PRNGKey(3)), p16)),
              "random": (d16, *_bridge(jm.init_params(d16, jax.random.PRNGKey(11)), pd16))}
    ref = _jax_run(models, mel, "random", gamma, None, False, cfg=cfg16)
    got = _port_run(models, mel, "random", gamma, None, False)
    _assert_equal_results(got, ref, False, stats=gamma == 1)
    model = models["target"][2]
    greedy = greedy_decode_kv(model, encode_cross_kv(model, torch.from_numpy(mel)),
                              torch.from_numpy(_prompt(cfg16)).long(), max_tokens=None)
    np.testing.assert_array_equal(got.tokens.numpy(), greedy.tokens.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_spec_decode_on_a_mesh_equals_unsharded(models, mel, quant):
    """Target and draft split over a (1, 2) mesh of two CPU ranks (the
    windows and the draft steps on each rank's local heads): the same
    tokens, lengths and counts as unsharded, log-probs within 1e-5."""
    from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params

    _, _, model = models["target"]
    _, _, dmodel = models["random"]
    mesh = make_mesh(1, 2, devices=["cpu", "cpu"])
    runs = []
    for t, d in ((model, dmodel), (shard_params(model, mesh), shard_params(dmodel, mesh))):
        m = torch.from_numpy(mel)
        runs.append(speculative_decode_kv(t, encode_cross_kv(t, m, kv_quant=quant), d,
                                          encode_cross_kv(d, m, kv_quant=quant),
                                          torch.from_numpy(_prompt(NANO)).long(), gamma=3,
                                          max_tokens=10, self_kv_quant=quant))
    one, many = runs
    _assert_equal_results(many, one, quant)


def test_spec_decode_refuses_another_vocabulary(models, mel):
    _, _, model = models["target"]
    other = types.SimpleNamespace(cfg=dataclasses.replace(PDRAFT, n_vocab=51866))
    cross = encode_cross_kv(model, torch.from_numpy(mel))
    with pytest.raises(AssertionError, match="vocabulary"):
        speculative_decode_kv(model, cross, other, cross,
                              torch.from_numpy(_prompt(NANO)).long())
    with pytest.raises(AssertionError):
        speculative_decode_kv(model, cross, model, cross,
                              torch.from_numpy(_prompt(NANO)).long(), gamma=0)


# ------------------------------------------------------------------ window
B_WIN, T_WIN = 5, 16


def _seeded_caches(cfg, quant, seed=6):
    """The same random cache contents on both sides (JAX, port)."""
    rng = np.random.default_rng(seed)
    L, H, dh = cfg.n_text_layer, cfg.n_text_head, cfg.head_dim_text
    if quant:
        q = rng.integers(-127, 128, (L, B_WIN, H, 2, dh, T_WIN)).astype(np.int8)
        s = rng.uniform(0.005, 0.02, (L, B_WIN, H, 2, T_WIN)).astype(np.float32)
        return (jm.QKVCache(jnp.asarray(q), jnp.asarray(s)),
                tm.QKVCache(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))
    k, v = (rng.standard_normal((L, B_WIN, H, dh, T_WIN)).astype(np.float32) for _ in range(2))
    return (jm.KVCache(jnp.asarray(k), jnp.asarray(v)),
            tm.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _window_cross(models, mel, kv_quant):
    _, jp, model = models["target"]
    jkv = jax_encode_cross_kv(jp, jnp.asarray(mel), NANO, kv_quant=kv_quant)
    jkv = tuple(a[:, [0, 1, 2, 0, 1]] for a in jkv)  # 5 rows over the 3 clips
    return jkv, tuple(torch.from_numpy(np.array(a)) for a in jkv)


def _near_ties(kh, eps=1e-5) -> np.ndarray:
    """(B, H, 2, dh, W) bool: x / s within ``eps`` of a .5 tie in
    quantize_kv_heads for the window's stacked (B, H, 2, W, dh) input."""
    r = (kh / (torch.clamp(kh.abs().amax(-1, keepdim=True), min=1e-12) / 127.0)).abs().numpy()
    return np.moveaxis(np.abs(r - np.floor(r) - 0.5) < eps, -1, -2)


WINDOW_OFFSETS = np.array([0, 5, 11, 13, 16])  # rows 3 and 4 cross the cache's end at T = 16
WINDOW_CASES = [(sq, kq, w) for sq in (False, True) for kq in (False, True) for w in (2, 5)]


@pytest.mark.parametrize("self_quant,kv_quant,W", WINDOW_CASES,
                         ids=[f"{'qkv' if a else 'kv'}-{'int8x' if b else 'fpx'}-w{w}"
                              for a, b, w in WINDOW_CASES])
def test_window_multipos_matches_jax(models, mel, monkeypatch, self_quant, kv_quant, W):
    """A width-W window with every row at its own offset, from the same
    random cache on both sides; rows 3 and 4 reach past T = 16 (row 4
    wholly). Every position the window does not write, the dropped ones
    included, keeps its old value on both sides; the float writes agree
    within 2e-4; the int8 ones are equal but for +-1 where the quantizer's
    x / s sits within 1e-5 of a .5 tie, and their scales within 2e-4
    relative. Logits within 2e-4, but for a row's queries at or after an
    int8 write one level apart (those queries read it)."""
    _, jp, model = models["target"]
    jkv, tkv = _window_cross(models, mel, kv_quant)
    toks = np.random.default_rng(8).integers(0, 50000, (B_WIN, W)).astype(np.int32)
    jcache, tcache = _seeded_caches(NANO, self_quant)
    before = [a.numpy().copy() for a in tcache]
    seen = []
    if self_quant:
        real = tm.quantize_kv_heads
        monkeypatch.setattr(tm, "quantize_kv_heads",
                            lambda kh, vh: seen.append(torch.stack([kh, vh], 2)) or real(kh, vh))
    jl, jcache = jm.decoder_window_multipos(jp, jnp.asarray(toks),
                                            jnp.asarray(WINDOW_OFFSETS, jnp.int32), jcache,
                                            jkv, NANO)
    tl, tcache = tm.decoder_window_multipos(model, torch.from_numpy(toks).long(),
                                            torch.from_numpy(WINDOW_OFFSETS).long(), tcache, tkv)
    assert tl.shape == (B_WIN, W, NANO.n_vocab) and tl.dtype == torch.float32
    got = [a.numpy() for a in tcache]
    want = [np.asarray(a) for a in jcache]
    written = np.zeros((B_WIN, T_WIN), bool)
    for b, o in enumerate(WINDOW_OFFSETS):
        written[b, o:min(o + W, T_WIN)] = True
    assert written[3].sum() == min(W, T_WIN - 13) and not written[4].any()
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(np.moveaxis(g, -1, 2)[:, ~written],
                                      np.moveaxis(b, -1, 2)[:, ~written])
        np.testing.assert_array_equal(np.moveaxis(w, -1, 2)[:, ~written],
                                      np.moveaxis(b, -1, 2)[:, ~written])
    read_flip = np.zeros((B_WIN, W), bool)  # (row, query) that reads a +-1 write
    if self_quant:
        np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=0)
        diff = got[0].astype(np.int32) - want[0].astype(np.int32)
        assert np.abs(diff).max() <= 1
        for layer, x in enumerate(seen):  # x: (B, H, 2, W, dh)
            ties = _near_ties(x)  # (B, H, 2, dh, W)
            d = np.moveaxis(diff[layer], -1, 1)  # (B, T, H, 2, dh)
            flips = np.zeros_like(read_flip)
            for b, o in enumerate(WINDOW_OFFSETS):
                for j in range(W):
                    if o + j < T_WIN and (d[b, o + j] != 0).any():
                        # a layer's input that read an earlier layer's
                        # flip is no longer the same on both sides
                        if not read_flip[b, j]:
                            assert not (d[b, o + j] != 0)[~ties[b, ..., j]].any(), (layer, b, j)
                        flips[b, j:] = True
            read_flip |= flips
        assert read_flip.sum() <= 2 * W  # a tie is rare: most queries are held
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tl.numpy()[~read_flip], np.asarray(jl)[~read_flip],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("self_quant", [False, True], ids=["kv", "qkv"])
def test_window_matches_sequential_port_steps(models, mel, self_quant):
    """The window equals W teacher-forced 1-wide ``decoder_step_multipos``
    calls at per-row offsets (JAX's test of its window, on the port): the
    logits and the cache within 2e-4 (float), the int8 cache equal but
    for +-1 at the quantizer's ties."""
    _, _, model = models["target"]
    cross = encode_cross_kv(model, torch.from_numpy(mel))
    B, W = 3, 4
    offs = torch.tensor([5, 7, 6])
    toks = torch.arange(B * W).reshape(B, W) + 100
    make = ((lambda: tm.QKVCache.create(PNANO, B, device="cpu")) if self_quant
            else (lambda: tm.KVCache.create(PNANO, B, device="cpu")))
    lw, kv_a = tm.decoder_window_multipos(model, toks, offs, make(), cross)
    kv_b = make()
    seq = []
    for j in range(W):
        lj, kv_b = tm.decoder_step_multipos(model, toks[:, j], offs + j, kv_b, cross)
        seq.append(lj)
    np.testing.assert_allclose(lw.numpy(), torch.stack(seq, 1).numpy(), rtol=0, atol=2e-4)
    if self_quant:
        assert (kv_a.q.int() - kv_b.q.int()).abs().max() <= 1
        np.testing.assert_allclose(kv_a.s.numpy(), kv_b.s.numpy(), rtol=2e-4, atol=0)
    else:
        for a, b in zip(kv_a, kv_b):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-4)


def test_window_targets_never_meet():
    """The write targets of every row are distinct and inside the cache for
    windows before, across and wholly past its end, so no two writes of
    ``index_put_`` meet."""
    T, W = 16, 5
    offsets = torch.arange(0, T + 2 * W)
    q_abs = offsets[:, None] + torch.arange(W)[None, :]
    at, inside = tm._window_targets(q_abs, T)
    assert torch.equal(inside, q_abs < T)
    assert ((at >= 0) & (at < T)).all()
    assert torch.equal(at[inside], q_abs[inside])
    for row in at:
        assert len(set(row.tolist())) == W


def test_window_refuses_more_tokens_than_the_cache(models, mel):
    _, _, model = models["target"]
    cross = encode_cross_kv(model, torch.from_numpy(mel[:1]))
    kv = tm.KVCache.create(PNANO, 1, ctx=4, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tm.decoder_window_multipos(model, torch.zeros((1, 5), dtype=torch.long),
                                   torch.zeros((1,), dtype=torch.long), kv, cross)
