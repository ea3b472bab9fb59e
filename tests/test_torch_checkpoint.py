"""The port's checkpoint loading and snapshot format against the JAX
package's (``whisper_tpu/models/checkpoint.py``), test-nano, on the CPU.

No checkpoint is in the repository, so the files are written here from the
JAX package's seeded ``init_params``: its own ``save_params`` snapshots
(plain and int8), OpenAI-named ``.pt`` files (with and without ``dims``) and
a bare ``.safetensors``, and HF directories, the OpenAI and HF state dicts
made by inverting the JAX converters. Loaded trees and models must equal
JAX's exactly (tolerance 0: the same fp32 numbers are moved, never
computed), and fp32 greedy tokens from a checkpoint must equal the JAX
pipeline's.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models import checkpoint as jc
from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import quantize_params as jax_quantize
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.models import checkpoint as tc
from whisper_tpu_torch.models.model import cast_floating
from whisper_tpu_torch.ops.quant import QTensor, quantize_logits_emb, quantize_params
from whisper_tpu_torch.params import from_jax_params, to_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
DIMS = {k: getattr(CFG, k) for k in ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
                                     "n_audio_layer", "n_vocab", "n_text_ctx", "n_text_state",
                                     "n_text_head", "n_text_layer")}


def _flat(tree, prefix=""):
    """{dotted path: numpy array} of a tree of dicts, arrays and QTensors
    (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return {prefix + "__q": np.asarray(tree.q), prefix + "__s": np.asarray(tree.s)}
    return {prefix.rstrip("."): np.asarray(tree)}


def assert_trees_equal(got, want):
    """Same paths, dtypes, shapes and values, exactly."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_models_equal(got, want):
    """Every weight of two port models, exactly (through their JAX-layout
    trees)."""
    assert_trees_equal(to_jax_params(got), to_jax_params(want))


def openai_state_dict(tree, cfg):
    """The inverse of the JAX ``from_openai_state_dict``."""
    enc, dec = tree["encoder"], tree["decoder"]
    sd = {"encoder.conv1.weight": enc["conv1"]["w"].transpose(2, 1, 0),
          "encoder.conv1.bias": enc["conv1"]["b"],
          "encoder.conv2.weight": enc["conv2"]["w"].transpose(2, 1, 0),
          "encoder.conv2.bias": enc["conv2"]["b"],
          "encoder.positional_embedding": enc["pos_emb"],
          "encoder.ln_post.weight": enc["ln_post"]["g"],
          "encoder.ln_post.bias": enc["ln_post"]["b"],
          "decoder.token_embedding.weight": dec["tok_emb"],
          "decoder.positional_embedding": dec["pos_emb"],
          "decoder.ln.weight": dec["ln"]["g"], "decoder.ln.bias": dec["ln"]["b"]}
    attn = {"wq": "query.weight", "bq": "query.bias", "wk": "key.weight", "wv": "value.weight",
            "bv": "value.bias", "wo": "out.weight", "bo": "out.bias"}
    mlp = {"w1": "mlp.0.weight", "b1": "mlp.0.bias", "w2": "mlp.2.weight", "b2": "mlp.2.bias"}
    subs = {"attn_ln": ("attn_ln", None), "attn": ("attn", attn), "mlp_ln": ("mlp_ln", None),
            "cross_ln": ("cross_attn_ln", None), "cross": ("cross_attn", attn), "mlp": ("", mlp)}
    for part, side, L in (("encoder", enc, cfg.n_audio_layer), ("decoder", dec, cfg.n_text_layer)):
        for sub, leaves in side["blocks"].items():
            stem, names = subs[sub]
            for key, stacked in leaves.items():
                for i in range(L):
                    if names is None:  # LayerNorm: g, b
                        name = f"{stem}.{'weight' if key == 'g' else 'bias'}"
                    else:
                        name = f"{stem}.{names[key]}" if stem else names[key]
                    w = stacked[i]
                    sd[f"{part}.blocks.{i}.{name}"] = w.T if key.startswith("w") else w
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


_HF_NAMES = [("encoder.conv", "model.encoder.conv"),
             ("encoder.positional_embedding", "model.encoder.embed_positions.weight"),
             ("encoder.ln_post", "model.encoder.layer_norm"),
             ("encoder.blocks", "model.encoder.layers"),
             ("decoder.token_embedding", "model.decoder.embed_tokens"),
             ("decoder.positional_embedding", "model.decoder.embed_positions.weight"),
             ("decoder.ln.", "model.decoder.layer_norm."),
             ("decoder.blocks", "model.decoder.layers"),
             (".cross_attn_ln.", ".encoder_attn_layer_norm."), (".cross_attn.", ".encoder_attn."),
             (".attn_ln.", ".self_attn_layer_norm."), (".attn.", ".self_attn."),
             (".mlp_ln.", ".final_layer_norm."), (".mlp.0.", ".fc1."), (".mlp.2.", ".fc2."),
             (".query.", ".q_proj."), (".key.", ".k_proj."), (".value.", ".v_proj."),
             (".out.", ".out_proj.")]


def hf_state_dict(tree, cfg):
    """The inverse of the JAX ``from_hf_state_dict``: the OpenAI dict renamed."""
    out = {}
    for k, v in openai_state_dict(tree, cfg).items():
        for a, b in _HF_NAMES:
            k = k.replace(a, b)
        out[k] = v
    return out


def _hf_config():
    return {"num_mel_bins": CFG.n_mels, "d_model": CFG.n_audio_state,
            "encoder_attention_heads": CFG.n_audio_head, "encoder_layers": CFG.n_audio_layer,
            "vocab_size": CFG.n_vocab, "max_target_positions": CFG.n_text_ctx,
            "max_source_positions": CFG.n_audio_ctx,
            "decoder_attention_heads": CFG.n_text_head, "decoder_layers": CFG.n_text_layer}


def _tensors(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jm.init_params(CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def files(tree, tmp_path_factory):
    """Every checkpoint kind, written from the JAX tree."""
    d = tmp_path_factory.mktemp("ckpt")
    sd, hf = openai_state_dict(tree, CFG), hf_state_dict(tree, CFG)
    out = {"pt_dims": str(d / "nano.pt"), "pt_bare": str(d / "bare.pt"),
           "safetensors_openai": str(d / "openai.safetensors"),
           "safetensors_hf": str(d / "hf.safetensors"),
           "hf_dir": str(d / "hf"), "hf_dir_bin": str(d / "hfbin")}
    torch.save({"dims": DIMS, "model_state_dict": _tensors(sd)}, out["pt_dims"])
    torch.save(_tensors(sd), out["pt_bare"])
    jc.save_safetensors(out["safetensors_openai"], sd)
    jc.save_safetensors(out["safetensors_hf"], hf)
    for key in ("hf_dir", "hf_dir_bin"):
        os.makedirs(out[key])
        with open(os.path.join(out[key], "config.json"), "w") as f:
            json.dump(_hf_config(), f)
    jc.save_safetensors(os.path.join(out["hf_dir"], "model.safetensors"), hf)
    torch.save(_tensors(hf), os.path.join(out["hf_dir_bin"], "pytorch_model.bin"))
    return out


KINDS = ("pt_dims", "pt_bare", "safetensors_openai", "safetensors_hf", "hf_dir", "hf_dir_bin")


def test_state_dict_inverses(tree):
    """The test's OpenAI and HF dicts invert the JAX converters exactly."""
    assert_trees_equal(jc.from_openai_state_dict(openai_state_dict(tree, CFG), CFG), tree)
    assert_trees_equal(jc.from_hf_state_dict(hf_state_dict(tree, CFG), CFG), tree)


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_tree_and_model_equal_jax(files, tree, kind):
    """Every kind of file: the port's tree equals JAX's ``load_checkpoint``
    leaf by leaf and the seeded tree it was written from; the port's
    ``load_checkpoint`` model equals ``from_jax_params`` of JAX's tree; the
    config is test-nano's."""
    want, _ = jc.load_checkpoint(files[kind], size="test-nano")
    got, cfg = tc.load_tree(files[kind], size="test-nano")
    assert_trees_equal(got, want)
    assert_trees_equal(got, tree)
    model, cfg2 = tc.load_checkpoint(files[kind], size="test-nano", device="cpu")
    assert_models_equal(model, from_jax_params(want, PCFG, device="cpu"))
    assert cfg == cfg2 == dataclasses.replace(PCFG, name=cfg.name)


def test_dims_config_counts_languages_as_openai():
    """A config made from a checkpoint's dims counts OpenAI's languages:
    n_vocab - 51765 - is_multilingual (99 for tiny, 100 for turbo, 99 unused
    slots for an English-only vocab) and so equals the preset. The JAX
    loader counts one more language (ROADMAP fault 3.8)."""
    for size in ("tiny", "turbo", "tiny.en"):
        want = port_config(size)
        dims = {k: getattr(want, k) for k in DIMS}
        got = tc._dims_to_config(dims, name=size)
        assert got == want
        if want.is_multilingual:
            assert jc._dims_to_config(dims, name=size).num_languages == want.num_languages + 1


def test_transformers_state_dict(tmp_path):
    """A random ``WhisperForConditionalGeneration``'s own state dict (a
    locally built config) in an HF directory: the port's tree equals JAX's."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=80, d_model=64, encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2, encoder_ffn_dim=256, decoder_ffn_dim=256,
        max_source_positions=48, max_target_positions=32)
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    sd = {k: v.detach().numpy().astype(np.float32) for k, v in model.state_dict().items()}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(hf_cfg.to_dict(), f)
    tc.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    want, _ = jc.load_checkpoint(str(tmp_path))
    got, cfg = tc.load_tree(str(tmp_path))
    assert_trees_equal(got, want)
    assert (cfg.n_audio_ctx, cfg.n_text_ctx, cfg.num_languages) == (48, 32, 99)


def _quantized(tree):
    return jax.tree.map(np.asarray, jax_quantize(tree))


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_port_snapshot_loads_in_jax(tree, tmp_path, quant):
    """``save_params`` of the port's model, read by JAX's ``load_params``:
    the JAX tree (int8 QTensors included) and config come back exactly."""
    want = _quantized(tree) if quant else tree
    path = str(tmp_path / "snap.safetensors")
    tc.save_params(path, from_jax_params(want, PCFG, device="cpu"))
    got, cfg = jc.load_params(path)
    assert_trees_equal(jax.tree.map(np.asarray, got), want)
    assert cfg == CFG


@pytest.mark.parametrize("quant", [False, True], ids=["plain", "int8"])
def test_jax_snapshot_loads_in_port(tree, tmp_path, quant):
    """JAX's ``save_params`` snapshot, read by the port's ``load_params``:
    the model equals ``from_jax_params`` of the tree it was written from."""
    want = _quantized(tree) if quant else tree
    path = str(tmp_path / "snap.safetensors")
    jc.save_params(path, want, CFG)
    model, cfg = tc.load_params(path, device="cpu")
    assert_models_equal(model, from_jax_params(want, PCFG, device="cpu"))
    assert cfg == PCFG
    assert_trees_equal(tc.load_params_tree(path)[0], jc.load_params(path)[0])


def test_snapshot_round_trip_bf16_int8_k_major(tree, tmp_path):
    """A pipeline's model (int8 weights, an int8 logits copy, bf16 floats,
    one payload laid out K-major in place) written and read back: bit-equal
    once cast to bf16 again (bf16 is written as fp32, as JAX writes it)."""
    model = cast_floating(quantize_logits_emb(quantize_params(
        from_jax_params(tree, PCFG, device="cpu"))), torch.bfloat16)
    model.encoder.blocks[0].attn["wq"].k_major()
    path = str(tmp_path / "snap.safetensors")
    tc.save_params(path, model)
    back, cfg = tc.load_params(path, device="cpu")
    cast_floating(back, torch.bfloat16)
    assert_models_equal(back, model)  # bf16 -> fp32 is exact: equal here is bit-equal
    dtypes = [str(x.dtype) for m in (model, back) for _, _, v in m.leaves()
              for x in ((v.q, v.s) if isinstance(v, QTensor) else (v,))]
    assert sorted(dtypes[:len(dtypes) // 2]) == sorted(dtypes[len(dtypes) // 2:])
    assert torch.equal(back.decoder.tok_emb_q8.q, model.decoder.tok_emb_q8.q)
    bare = str(tmp_path / "noconf.safetensors")
    tc.save_safetensors(bare, {"x": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="no config"):
        tc.load_params(bare, device="cpu")


def _bad_files(d, files):
    trunc, long_hdr = str(d / "trunc.safetensors"), str(d / "long.safetensors")
    with open(trunc, "wb") as f:
        f.write(b"\x01\x02\x03")
    with open(long_hdr, "wb") as f:
        f.write((10 ** 9).to_bytes(8, "little") + b"{}")
    os.makedirs(d / "empty", exist_ok=True)
    return {"truncated header": (lambda m: m.load_safetensors(trunc), ValueError),
            "truncated snapshot": (lambda m: m.load_params(trunc) if m is jc
                                   else m.load_params(trunc, device="cpu"), ValueError),
            "overlong header": (lambda m: m.load_safetensors(long_hdr), ValueError),
            "bare safetensors without size": (
                lambda m: (m.load_checkpoint if m is jc else m.load_tree)(
                    files["safetensors_openai"]), ValueError),
            ".pt without dims or size": (
                lambda m: (m.load_checkpoint if m is jc else m.load_tree)(files["pt_bare"]),
                ValueError),
            "directory without weights": (
                lambda m: (m.load_checkpoint if m is jc else m.load_tree)(str(d / "empty")),
                FileNotFoundError)}


ERRORS = ("truncated header", "truncated snapshot", "overlong header",
          "bare safetensors without size", ".pt without dims or size",
          "directory without weights")


@pytest.mark.parametrize("case", ERRORS)
def test_errors_match_jax(files, tmp_path, case):
    call, exc = _bad_files(tmp_path, files)[case]
    for mod in (jc, tc):
        with pytest.raises(exc):
            call(mod)


@pytest.mark.parametrize("kind", ["pt_bare", "safetensors_hf"])
def test_pipeline_checkpoint_tokens_equal_jax(files, kind):
    """``WhisperPipeline(checkpoint=...)``, fp32, int8 cross- and self-KV:
    the JAX pipeline's tokens and texts from the same file, two clips."""
    kw = dict(model="test-nano", checkpoint=files[kind], compute_dtype="float32", max_tokens=8,
              kv_quant=True, self_kv_quant=True, language="zh", temperature_fallback=False)
    rng = np.random.default_rng(3)
    clips = [(0.1 * rng.standard_normal(16000 * s)).astype(np.float32) for s in (2, 5)]
    want = JaxPipeline(**kw).transcribe_batch(clips)
    pipe = WhisperPipeline(device="cpu", **kw)
    got = pipe.transcribe_batch(clips)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
        assert a.text == b.text and a.language == b.language == "zh"


def test_pipeline_checkpoint_turns_the_ladder_on(files):
    """As in JAX, a checkpoint turns the temperature ladder on unless told
    otherwise; checkpoint and params together are refused."""
    assert WhisperPipeline(model="test-nano", checkpoint=files["pt_dims"],
                           device="cpu").temperature_fallback
    assert not WhisperPipeline(model="test-nano", device="cpu").temperature_fallback
    with pytest.raises(ValueError, match="not both"):
        WhisperPipeline(model="test-nano", checkpoint=files["pt_dims"], device="cpu",
                        params=object())
