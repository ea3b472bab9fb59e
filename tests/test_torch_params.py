"""The port's weight bridge and seeded init against the JAX pytree."""

import jax
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.models.model import init_params as jax_init
from whisper_tpu.ops.quant import quantize_logits_emb as jax_qlogits
from whisper_tpu.ops.quant import quantize_params as jax_qparams
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.models.model import KVCache, QKVCache
from whisper_tpu_torch.ops.quant import QTensor, quantize_logits_emb, quantize_params
from whisper_tpu_torch.params import from_jax_params, init_params

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(CFG, jax.random.PRNGKey(0))


def _to_jax_layout(model):
    """The port's state back in the JAX pytree layout (numpy leaves)."""
    def arr(x):
        if isinstance(x, QTensor):
            return (x.q.numpy(), x.s.numpy())
        return x.numpy()

    def stack(blocks):
        out = {}
        for sub, leaves in blocks[0].sublayers().items():
            out[sub] = {}
            for k in leaves:
                vals = [arr(b.sublayers()[sub][k]) for b in blocks]
                out[sub][k] = (tuple(np.stack(v) for v in zip(*vals))
                               if isinstance(vals[0], tuple) else np.stack(vals))
        return out

    enc, dec = model.encoder, model.decoder
    tree = {
        "encoder": {
            "conv1": {"w": enc.conv1["w"].numpy().transpose(2, 1, 0), "b": enc.conv1["b"].numpy()},
            "conv2": {"w": enc.conv2["w"].numpy().transpose(2, 1, 0), "b": enc.conv2["b"].numpy()},
            "pos_emb": enc.pos_emb.numpy(),
            "blocks": stack(list(enc.blocks)),
            "ln_post": {k: v.numpy() for k, v in enc.ln_post.items()},
        },
        "decoder": {
            "tok_emb": dec.tok_emb.numpy(),
            "pos_emb": dec.pos_emb.numpy(),
            "blocks": stack(list(dec.blocks)),
            "ln": {k: v.numpy() for k, v in dec.ln.items()},
        },
    }
    if dec.tok_emb_q8 is not None:
        tree["decoder"]["tok_emb_q8"] = arr(dec.tok_emb_q8)
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return {prefix: (np.asarray(tree.q), np.asarray(tree.s))}
    return {prefix: tree}


def test_round_trip_fp32(jax_params):
    ref = _flat(_np_tree(jax_params))
    got = _flat(_to_jax_layout(from_jax_params(_np_tree(jax_params), PCFG, device="cpu")))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_round_trip_quantized(jax_params):
    jq = jax_qlogits(jax_qparams(jax_params))
    model = from_jax_params(_np_tree(jq), PCFG, device="cpu")
    wq = model.decoder.blocks[1].cross["wq"]
    assert isinstance(wq, QTensor) and wq.q.dtype == torch.int8
    assert wq.s.dtype == torch.float32 and tuple(wq.s.shape) == (1, PCFG.n_text_state)
    assert tuple(model.decoder.tok_emb_q8.s.shape) == (PCFG.n_vocab, 1)
    ref = _flat(_np_tree(jq))
    got = _flat(_to_jax_layout(model))
    assert sorted(got) == sorted(ref)
    for k in ref:
        for a, b in zip(got[k] if isinstance(got[k], tuple) else (got[k],),
                        ref[k] if isinstance(ref[k], tuple) else (ref[k],)):
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_conv_transpose(jax_params):
    model = from_jax_params(_np_tree(jax_params), PCFG, device="cpu")
    w_jax = np.asarray(jax_params["encoder"]["conv1"]["w"])  # (3, C_in, C_out) WIO
    w = model.encoder.conv1["w"].numpy()                      # (C_out, C_in, 3)
    assert w.shape == (CFG.n_audio_state, CFG.n_mels, 3)
    np.testing.assert_array_equal(w[5, 7, 2], w_jax[2, 7, 5])


@pytest.mark.parametrize("which", ["weights", "logits_emb"])
def test_port_quantizer_matches_jax(jax_params, which):
    """Quantizing the bridged fp32 weights in the port gives the JAX
    package's int8 payloads (at most a 1e-3 share off by one LSB) and
    scales."""
    model = from_jax_params(_np_tree(jax_params), PCFG, device="cpu")
    if which == "weights":
        quantize_params(model)
        ref = from_jax_params(_np_tree(jax_qparams(jax_params)), PCFG, device="cpu")
        pairs = [(getattr(b, s)[k], getattr(r, s)[k])
                 for b, r in zip(list(model.encoder.blocks) + list(model.decoder.blocks),
                                 list(ref.encoder.blocks) + list(ref.decoder.blocks))
                 for s in ("attn", "mlp") for k in getattr(b, s) if k[0] == "w"]
    else:
        quantize_logits_emb(model)
        ref = from_jax_params(_np_tree(jax_qlogits(jax_params)), PCFG, device="cpu")
        pairs = [(model.decoder.tok_emb_q8, ref.decoder.tok_emb_q8)]
    for got, want in pairs:
        diff = (got.q.to(torch.int32) - want.q.to(torch.int32)).abs()
        assert int(diff.max()) <= 1
        assert float((diff > 0).float().mean()) <= 1e-3
        torch.testing.assert_close(got.s, want.s, rtol=1e-6, atol=0)


def test_init_params_shapes_and_scales(jax_params):
    ref = _flat(_np_tree(jax_params))
    got = _flat(_to_jax_layout(init_params(PCFG, seed=0, device="cpu")))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == ref[k].dtype, k
        if k.endswith("pos_emb") and k.startswith("/encoder"):
            np.testing.assert_allclose(got[k], ref[k], atol=1e-5)
        elif ref[k].std() > 0:  # random leaves: same scale, other numbers
            assert 0.8 < got[k].std() / ref[k].std() < 1.25, k
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_init_params_is_seeded():
    a = init_params(PCFG, seed=7, device="cpu")
    b = init_params(PCFG, seed=7, device="cpu")
    c = init_params(PCFG, seed=8, device="cpu")
    assert torch.equal(a.decoder.tok_emb, b.decoder.tok_emb)
    assert not torch.equal(a.decoder.tok_emb, c.decoder.tok_emb)


@pytest.mark.parametrize("builder", ["init_params", "from_jax_params", "KVCache", "QKVCache"])
def test_builders_require_a_device(jax_params, builder):
    """No builder picks a device for its caller."""
    build = {"init_params": lambda: init_params(PCFG, seed=0),
             "from_jax_params": lambda: from_jax_params(_np_tree(jax_params), PCFG),
             "KVCache": lambda: KVCache.create(PCFG, 1),
             "QKVCache": lambda: QKVCache.create(PCFG, 1)}[builder]
    with pytest.raises(TypeError, match="device"):
        build()
