"""The kernels of the JAX package's kernel selections, and the port's
``encoder_attention`` / ``cross_decode`` selections that run them, against
the JAX package.

Kernel level: split-head encoder attention (K6), head-batched int8
cross-attention decode (K4, both forms) and its block-diagonal dense form
(K5), each wrapper's plain version (the CPU branch) against the Pallas
kernel in interpret mode, as tests/test_pallas.py runs them.

Slice level (test-nano, fp32): the JAX side runs under
``WHISPER_TPU_FLASH=bhtd`` and ``_DECODE_FLASH_KIND`` set, with its
split-head and decode kernels wrapped into interpret mode (the model looks
them up at call time) and the jit caches cleared around each test, since the
selections are read at trace time. The hand-written kernels are held against
these plain versions on the card by tests/test_torch_kernels_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.ops.decode_attention as jda
import whisper_tpu.ops.flash_attention as jfa
from whisper_tpu.config import get_config
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.models.model import quantize_cross_kv as jax_quantize_cross_kv
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.ops.decode_attention import (
    cross_attention_decode,
    cross_attention_decode_dense,
)
from whisper_tpu_torch.ops.flash_attention import flash_attention
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

# fp32 on both sides, products summed in another order
FP32_TOL = 2e-4
# a bf16 query: the same roundings on both sides (the scaled query and the
# weights to bf16); an output near 1 may land one bf16 ulp (2^-7) apart only
# through a rounding of another sum order, far below that in practice
BF16_TOL = 8e-3


# ------------------------------------------------------------- kernel level
def _attn_inputs(seed, B, H, Tq, Tk, dh=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, dh)).astype(np.float32),
            rng.standard_normal((B, H, Tk, dh)).astype(np.float32),
            rng.standard_normal((B, H, Tk, dh)).astype(np.float32))


@pytest.mark.parametrize("B,H,Tq,Tk", [(2, 2, 150, 150), (1, 2, 100, 64), (2, 3, 37, 261)],
                         ids=["ragged-T", "Tq>Tk", "Tq<Tk"])
def test_flash_attention_matches_pallas(B, H, Tq, Tk):
    """K6's plain version against the Pallas kernel (interpret mode) at a
    ragged T (a last q tile of 22 at q_tile=64, keys padded to 256 and
    masked) and at Tq != Tk, as tests/test_pallas.py:28."""
    q, k, v = _attn_inputs(Tq + Tk, B, H, Tq, Tk)
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         interpret=True, q_tile=64))
    before = flash_attention.launches
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert flash_attention.launches == before  # the plain version is no launch
    assert got.shape == ref.shape == (B, H, Tq, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FP32_TOL)


def _cross_inputs(seed, B=2, H=3, T=300, dh=64):
    """q (B, H, 1, dh) and the JAX-quantized int8 cross-KV of one layer."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, dh)).astype(np.float32)
    ck = rng.standard_normal((1, B, H, T, dh)).astype(np.float32)
    cv = rng.standard_normal((1, B, H, T, dh)).astype(np.float32)
    jq = jax_quantize_cross_kv((jnp.asarray(ck), jnp.asarray(cv)))
    return q, tuple(np.array(a[0]) for a in jq)


def _both(q, kv, dtype):
    """(JAX args, port args) with the query in ``dtype`` on both sides."""
    jq = jnp.asarray(q).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tq = torch.from_numpy(q).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return ((jq,) + tuple(jnp.asarray(a) for a in kv),
            (tq,) + tuple(torch.from_numpy(a) for a in kv))


CROSS_CASES = [("fp32", FP32_TOL), ("bf16", BF16_TOL)]


@pytest.mark.parametrize("use_vpu", [False, True], ids=["mxu", "vpu"])
@pytest.mark.parametrize("dtype,tol", CROSS_CASES, ids=["fp32", "bf16"])
def test_cross_attention_decode_matches_pallas(use_vpu, dtype, tol):
    """K4's plain version against ``cross_attention_decode`` (interpret)
    in both forms: B=2, H=3, T=300, dh=64; the bf16 query rounds the scaled
    query and the weights to bf16 on both sides in the MXU form."""
    q, kv = _cross_inputs(11)
    jargs, targs = _both(q, kv, dtype)
    ref = np.asarray(jda.cross_attention_decode(*jargs, interpret=True, use_vpu=use_vpu)
                     .astype(jnp.float32))
    before = cross_attention_decode.launches
    got = cross_attention_decode(*targs, use_vpu=use_vpu)
    assert cross_attention_decode.launches == before
    assert got.shape == (2, 3, 1, 64) and got.dtype == targs[0].dtype
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_attention_decode_dense_matches_pallas(dtype):
    """K5's plain version against ``cross_attention_decode_dense``
    (interpret): bf16 operands whatever the query's dtype, fp32 softmax and
    accumulation, 8e-3 abs (an output may sit one bf16 ulp apart where a
    weight's rounding falls differently after another sum order)."""
    q, kv = _cross_inputs(12, B=2, H=4, T=200)
    jargs, targs = _both(q, kv, dtype)
    ref = np.asarray(jda.cross_attention_decode_dense(*jargs, interpret=True)
                     .astype(jnp.float32))
    before = cross_attention_decode_dense.launches
    got = cross_attention_decode_dense(*targs)
    assert cross_attention_decode_dense.launches == before
    assert got.shape == (2, 4, 1, 64) and got.dtype == targs[0].dtype
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=BF16_TOL)


def test_dense_rounds_an_fp32_query_and_legacy_does_not():
    """On an fp32 query K5 still rounds to bf16 and K4's MXU form does not:
    K4 equals its all-fp32 form and K2's semantics; K5 sits a bf16 rounding
    away from both, yet within BF16_TOL."""
    from whisper_tpu_torch.ops.decode_attention import cross_attention_decode_fd

    q, kv = _cross_inputs(13)
    _, targs = _both(q, kv, "fp32")
    mxu = cross_attention_decode(*targs)
    np.testing.assert_array_equal(mxu.numpy(), cross_attention_decode(*targs, use_vpu=True)
                                  .numpy())
    np.testing.assert_allclose(mxu.numpy(), cross_attention_decode_fd(*targs).numpy(),
                               rtol=0, atol=1e-5)
    dense = cross_attention_decode_dense(*targs)
    assert float((dense - mxu).abs().max()) > 1e-5
    np.testing.assert_allclose(dense.numpy(), mxu.numpy(), rtol=0, atol=BF16_TOL)


def test_new_wrappers_refuse_other_devices():
    meta = torch.empty((1, 2, 4, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta, meta)
    q = torch.empty((1, 2, 1, 64), device="meta")
    kq = torch.empty((1, 2, 64, 8), device="meta", dtype=torch.int8)
    s = torch.empty((1, 2, 1, 64), device="meta")
    for use_vpu in (False, True):
        with pytest.raises(ValueError):
            cross_attention_decode(q, kq, s, kq, s, use_vpu=use_vpu)
    with pytest.raises(ValueError):
        cross_attention_decode_dense(q, kq, s, kq, s)


# -------------------------------------------------------------- slice level
CFG = get_config("test-nano")
PCFG = port_config("test-nano")
MAX_TOKENS = 10


@pytest.fixture
def jax_selection(monkeypatch):
    """Set the JAX package's two selections, with its Pallas kernels in
    interpret mode; clear the jit caches before and after, since the
    selections are read at trace time."""

    def select(flash: str, decode_kind: str):
        monkeypatch.setenv("WHISPER_TPU_FLASH", flash)
        monkeypatch.setattr(jm, "_DECODE_FLASH_KIND", decode_kind)
        monkeypatch.setattr(jfa, "flash_attention",
                            functools.partial(jfa.flash_attention, interpret=True))
        for name in ("cross_attention_decode", "cross_attention_decode_dense",
                     "cross_attention_decode_fd"):
            monkeypatch.setattr(jda, name, functools.partial(getattr(jda, name),
                                                             interpret=True))

    jax.clear_caches()
    yield select
    jax.clear_caches()


@pytest.fixture(scope="module")
def bridged():
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


def _mel(seed, B=3):
    return np.random.default_rng(seed).standard_normal(
        (B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def test_encoder_bhtd_matches_jax_bhtd(bridged, jax_selection):
    """encoder_forward(attn="bhtd") against JAX's encoder under
    WHISPER_TPU_FLASH=bhtd (its split-head kernel, interpret mode), and
    against the port's default (B, T, D) path, fp32 at 1e-4."""
    jp, model = bridged
    jax_selection("bhtd", None)
    mel = _mel(1, B=2)
    ref = np.asarray(jm.encoder_forward(jp, jnp.asarray(mel), CFG))
    got = tm.encoder_forward(model, torch.from_numpy(mel), attn="bhtd").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    btd = tm.encoder_forward(model, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, btd, rtol=0, atol=1e-5)


def test_pipeline_bhtd_legacy_tokens_equal_jax(bridged, jax_selection):
    """Greedy tokens of WhisperPipeline(encoder_attention="bhtd",
    cross_decode="legacy", kv_quant=True) equal JAX's under
    WHISPER_TPU_FLASH=bhtd and the legacy decode kernel (fp32, test-nano,
    the rules on)."""
    jp, model = bridged
    jax_selection("bhtd", "legacy")
    rng = np.random.default_rng(3)
    clips = [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (3, 7, 2)]
    pipe = WhisperPipeline(model="test-nano", device="cpu", compute_dtype="float32",
                           kv_quant=True, max_tokens=MAX_TOKENS, params=model,
                           encoder_attention="bhtd", cross_decode="legacy")
    pipe.transcribe_batch(clips)
    got = pipe.last_decode

    from whisper_tpu_torch.ops.mel import log_mel_batch

    audio = np.zeros((3, 480000), np.float32)
    for i, c in enumerate(clips):
        audio[i, :len(c)] = c
    mel = log_mel_batch(torch.from_numpy(audio), torch.tensor([len(c) for c in clips]),
                        n_mels=CFG.n_mels)[..., :2 * CFG.n_audio_ctx].numpy()
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int32), (3, 1))
    suppress = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
    jkv = jm.quantize_cross_kv(jm.compute_cross_kv(
        jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG))
    ref = jax_greedy_decode_kv(jp, jkv, jnp.asarray(prompt), CFG, max_tokens=MAX_TOKENS,
                               suppress_ids=jnp.asarray(suppress), apply_filters=True)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert got.steps > 0


def _step_inputs(jp, seed=7, B=5, T=16):
    """One multipos step's inputs on both sides: int8 cross-KV of two clips
    spread over B rows, a float self-KV cache seeded with noise, ragged
    offsets (0 = one visible key ... T-1) and tokens."""
    mel = _mel(seed, B=2)
    jkv = jm.quantize_cross_kv(jm.compute_cross_kv(
        jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG))
    jkv = tuple(a[:, [0, 1, 0, 1, 0]] for a in jkv)
    rng = np.random.default_rng(seed)
    shape = (CFG.n_text_layer, B, CFG.n_text_head, CFG.n_text_state // CFG.n_text_head, T)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    offsets = np.array([0, 3, 9, 15, 12], np.int32)
    toks = rng.integers(0, 50000, B).astype(np.int32)
    return jkv, (k, v), offsets, toks


# the dense form rounds the scaled query and the weights to bf16 on both
# sides even in fp32; where both round alike the logits agree as the fp32
# forms do (1.9e-6 here), and a weight rounded the other way after another
# summation order moves them by ~|w| 2^-8 |v| through one layer, below 1e-3
DENSE_LOGITS_TOL = 1e-3


@pytest.mark.parametrize("kind,atol", [("legacy", 1e-4), ("dense", DENSE_LOGITS_TOL)])
def test_decoder_step_multipos_matches_jax(bridged, jax_selection, kind, atol):
    """The engine's step with cross_decode="legacy" against JAX's under the
    legacy decode kernel at 1e-4 (fp32: no rounding on either side), and
    with "dense" against JAX's dense kernel at DENSE_LOGITS_TOL."""
    jp, model = bridged
    jax_selection("auto", kind)
    jkv, (k, v), offsets, toks = _step_inputs(jp)
    jl, _ = jm.decoder_step_multipos(jp, jnp.asarray(toks), jnp.asarray(offsets),
                                     jm.KVCache(jnp.asarray(k), jnp.asarray(v)), jkv, CFG)
    tcache = tm.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    tl, _ = tm.decoder_step_multipos(model, torch.from_numpy(toks).long(),
                                     torch.from_numpy(offsets).long(), tcache,
                                     tuple(torch.from_numpy(np.array(a)) for a in jkv),
                                     cross_decode=kind)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)


def test_dense_greedy_logits_match_jax(bridged, jax_selection):
    """decoder_forward at S=1 (the pipeline's step) with cross_decode="dense"
    against JAX's decoder_forward under the dense kernel, from the same
    prefilled cache: logits within DENSE_LOGITS_TOL, and the default "fd"
    logits of the port sit no closer to JAX's dense ones than the dense
    port does."""
    jp, model = bridged
    jax_selection("auto", "dense")
    mel = _mel(4, B=2)
    jkv = jm.quantize_cross_kv(jm.compute_cross_kv(
        jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG))
    tkv = tuple(torch.from_numpy(np.array(a)) for a in jkv)
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int32), (2, 1))
    P = prompt.shape[1]
    jcache = jm.KVCache.create(CFG, 2, ctx=16)
    _, jcache = jm.decoder_forward(jp, jnp.asarray(prompt), 0, jcache, jkv, CFG)
    step = np.array([[100], [2000]], np.int32)
    jl, _ = jm.decoder_forward(jp, jnp.asarray(step), P, jcache, jkv, CFG)

    out = {}
    for kind in ("dense", "fd"):
        kv = tm.KVCache.create(PCFG, 2, ctx=16, device="cpu")
        tm.decoder_forward(model, torch.from_numpy(prompt).long(), 0, kv, tkv,
                           cross_decode=kind)
        out[kind], _ = tm.decoder_forward(model, torch.from_numpy(step).long(), P, kv, tkv,
                                          cross_decode=kind)
    ref = np.asarray(jl)
    np.testing.assert_allclose(out["dense"].numpy(), ref, rtol=0, atol=DENSE_LOGITS_TOL)
    assert (np.abs(out["dense"].numpy() - ref).max()
            <= np.abs(out["fd"].numpy() - ref).max())


@pytest.mark.parametrize("where", ["encoder", "decoder", "step", "pipeline"])
def test_unknown_selections_raise(bridged, where):
    _, model = bridged
    mel = torch.zeros((1, CFG.n_mels, 2 * CFG.n_audio_ctx))
    with pytest.raises(ValueError):
        if where == "encoder":
            tm.encoder_forward(model, mel, attn="xla")
        elif where == "decoder":
            kv = tm.KVCache.create(PCFG, 1, ctx=16, device="cpu")
            cross = tm.compute_cross_kv(model, tm.encoder_forward(model, mel))
            tm.decoder_forward(model, torch.zeros((1, 1), dtype=torch.long), 0, kv,
                               tm.quantize_cross_kv(cross), cross_decode="0")
        elif where == "step":
            kv = tm.KVCache.create(PCFG, 1, ctx=16, device="cpu")
            cross = tm.compute_cross_kv(model, tm.encoder_forward(model, mel))
            tm.decoder_step_multipos(model, torch.zeros((1,), dtype=torch.long),
                                     torch.zeros((1,), dtype=torch.long), kv, cross,
                                     cross_decode="vpu")
        else:
            WhisperPipeline(model="test-nano", device="cpu", params=model,
                            cross_decode="flash")


def test_cli_and_server_parsers_pass_the_selections(monkeypatch):
    """Both entry points accept the two flags, refuse other values, and hand
    them to the pipeline and the engine; the defaults are the paths' kernels
    before the flags existed (btd, fd)."""
    from whisper_tpu_torch import cli
    from whisper_tpu_torch.serving import __main__ as srv

    args = cli.get_args(["--wav", "a.wav"])
    assert (args.encoder_attention, args.cross_decode) == ("btd", "fd")
    args = cli.get_args(["--wav", "a.wav", "--encoder_attention", "bhtd",
                         "--cross_decode", "dense"])
    assert (args.encoder_attention, args.cross_decode) == ("bhtd", "dense")
    with pytest.raises(SystemExit):
        cli.get_args(["--wav", "a.wav", "--cross_decode", "xla"])

    seen = {}

    class Pipe:
        def __init__(self, **kw):
            seen.update(kw)
            raise RuntimeError("stop")

    monkeypatch.setattr("whisper_tpu_torch.pipeline.WhisperPipeline", Pipe)
    with pytest.raises(RuntimeError):
        cli.main(["--wav", "a.wav", "--device", "cpu", "--encoder_attention", "bhtd",
                  "--cross_decode", "legacy"])
    assert (seen["encoder_attention"], seen["cross_decode"]) == ("bhtd", "legacy")

    a = srv.parse_args([])
    assert (a.encoder_attention, a.cross_decode) == ("btd", "fd")
    a = srv.parse_args(["--model_type", "test-nano", "--device", "cpu", "--dtype", "float32",
                        "--no-w8a8", "--encoder_attention", "bhtd", "--cross_decode", "dense"])
    engine, _ = srv.build_engine(a)
    assert (engine.encoder_attention, engine.cross_decode) == ("bhtd", "dense")
    with pytest.raises(SystemExit):
        srv.parse_args(["--encoder_attention", "0"])
