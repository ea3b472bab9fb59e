"""Tensor and data parallelism in the port (CPU, fp32 unless W8A8): the mesh
and specs against ``whisper_tpu/parallel/sharding.py``, the sharded BTD
entry against JAX's (Pallas in interpret mode on the conftest's virtual CPU
devices), sharded decode (greedy, beam, speculative, detection, the
alignment pass) on (data, model) meshes and the engine against the
unsharded port and JAX (``tests/test_sharding.py``'s shapes). Ranks and
data rows of a port mesh may share a device (``devices=["cpu"] * n``), as
on one card."""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from whisper_tpu.config import WhisperConfig as JaxConfig
from whisper_tpu.config import get_config as jax_get_config
from whisper_tpu.decode import greedy_decode as jax_greedy_decode
from whisper_tpu.models.model import init_params as jax_init_params
from whisper_tpu.ops.flash_attention import flash_attention_btd_sharded as jax_btd_sharded
from whisper_tpu.parallel import sharding as js
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch.config import WhisperConfig, get_config
from whisper_tpu_torch.decode import greedy_decode
from whisper_tpu.beam import beam_search as jax_beam_search
from whisper_tpu.decode import detect_language_kv as jax_detect_language_kv
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.spec_decode import speculative_decode_kv as jax_speculative_decode_kv
from whisper_tpu_torch.align import alignment_matrix
from whisper_tpu_torch.beam import beam_search
from whisper_tpu_torch.decode import detect_language_kv, encode_cross_kv
from whisper_tpu_torch.models.model import (
    DataParallelWhisper,
    DataRows,
    ShardedWhisper,
    decoder_forward,
    encoder_forward,
    new_kv_cache,
)
from whisper_tpu_torch.spec_decode import speculative_decode_kv
from whisper_tpu_torch.ops.flash_attention import (
    flash_attention_btd,
    flash_attention_btd_local,
    flash_attention_btd_sharded,
)
from whisper_tpu_torch.ops.quant import quantize_logits_emb, quantize_params
from whisper_tpu_torch.parallel import distributed
from whisper_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    _fit_spec,
    data_specs,
    make_mesh,
    param_specs,
    shard_params,
)
from whisper_tpu_torch.params import from_jax_params, init_params
from whisper_tpu_torch.serving.__main__ import build_engine, parse_args
from whisper_tpu_torch.serving.__main__ import main as serve_main
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

# tests/test_sharding.py's nano-shard shape (4 heads, so tp 2 and 4 divide
# them), with a multilingual vocabulary the port indexes: 51864 splits at
# tp 2 and 4, turbo's 51866 at tp 2 only
NANO = dict(name="nano-shard", n_mels=80, n_audio_ctx=32, n_audio_state=64, n_audio_head=4,
            n_audio_layer=2, n_text_ctx=16, n_text_state=64, n_text_head=4, n_text_layer=2)


def _cpu_mesh(tp, n_data=1):
    return make_mesh(n_data, tp, devices=["cpu"] * (n_data * tp))


def _jax_mesh(n_data, tp):
    return js.make_mesh(n_data, tp, devices=jax.devices()[: n_data * tp])


# ---------------------------------------------------------------- mesh, specs
def test_param_specs_cover_the_jax_tree_and_equal_jax():
    cfg = JaxConfig(**NANO, n_vocab=51864)
    port = param_specs(get_config("tiny"))
    jax.tree.map(lambda a, s: None, jax_init_params(cfg), port)  # raises on a mismatch
    want = jax.tree.map(tuple, js.param_specs(cfg), is_leaf=lambda x: isinstance(x, P))
    assert port == want
    assert data_specs() == jax.tree.map(tuple, js.data_specs(),
                                        is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("tp", [2, 4])
def test_fit_spec_turbo_vocab_equals_jax(tp):
    """Turbo's 51,866-row embedding splits over MODEL at tp 2 and is
    replicated at tp 4, as the JAX ``_fit_spec`` decides."""
    shape = (51866, 1280)
    for spec in ((MODEL_AXIS, None), (None, MODEL_AXIS), (DATA_AXIS, MODEL_AXIS)):
        want = tuple(js._fit_spec(P(*spec), shape, _jax_mesh(1, tp)))
        assert _fit_spec(spec, shape, _cpu_mesh(tp)) == want
    assert _fit_spec((MODEL_AXIS, None), shape, _cpu_mesh(tp)) == (
        (MODEL_AXIS, None) if tp == 2 else (None, None))


def test_make_mesh_shapes_and_refusals(monkeypatch):
    mesh = make_mesh(1, 2, devices=["cpu", "cpu"])
    assert mesh.shape == {DATA_AXIS: 1, MODEL_AXIS: 2}
    assert mesh.model_devices() == [torch.device("cpu")] * 2
    assert make_mesh(n_model=2, devices=["cpu"] * 4).shape == {DATA_AXIS: 2, MODEL_AXIS: 2}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(1, 2, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="CUDA"):
        make_mesh(1, 2)  # distinct cards by default: one is too few
    assert make_mesh(1, 1).model_devices() == [torch.device("cuda", 0)]


def test_distributed_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()  # one process: nothing to set up
    assert not torch.distributed.is_initialized()
    assert distributed.local_batch_slice(8) == slice(0, 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        distributed.serving_mesh(2)


def test_distributed_initialize_two_processes():
    """``initialize`` from torchrun's environment in two gloo processes on
    localhost; each process gets its half of a global batch."""
    code = """
import torch
from whisper_tpu_torch.parallel import distributed
distributed.initialize()
s = distributed.local_batch_slice(8)
print(torch.distributed.get_rank(), torch.distributed.get_world_size(), s.start, s.stop)
torch.distributed.destroy_process_group()
"""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               PYTHONPATH=str(pathlib.Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(o.split() for o, _ in outs) == [["0", "2", "0", "4"], ["1", "2", "4", "8"]]


# ---------------------------------------------------------------- the sharded BTD entry
@pytest.mark.parametrize("n_data,tp", [(1, 2), (1, 4), (2, 2)])
def test_sharded_entry_equals_jax(n_data, tp):
    """``flash_attention_btd_sharded`` against the JAX entry (shard_map over a
    CPU mesh, Pallas interpreted): 8 heads of 64, batch over DATA, columns
    over MODEL; 1e-5 in fp32. It also equals the unsharded kernel's plain
    version."""
    rng = np.random.default_rng(n_data * 10 + tp)
    q, k, v = (rng.standard_normal((2, 40, 512)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_btd_sharded(*(jnp.asarray(t) for t in (q, k, v)), 8,
                                      _jax_mesh(n_data, tp), interpret=True))
    got = flash_attention_btd_sharded(*(torch.from_numpy(t) for t in (q, k, v)), 8,
                                      _cpu_mesh(tp, n_data))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    full = flash_attention_btd(*(torch.from_numpy(t) for t in (q, k, v)), 8)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=1e-6)


def test_sharded_entry_refuses_uneven_heads_and_counts_no_cpu_launch():
    q = torch.zeros((1, 8, 6 * 64))
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention_btd_sharded(q, q, q, 6, _cpu_mesh(4))
    before = flash_attention_btd_sharded.launches
    flash_attention_btd_local([q[..., :192].contiguous()] * 2, [q[..., :192].contiguous()] * 2,
                              [q[..., :192].contiguous()] * 2, 6)
    assert flash_attention_btd_sharded.launches == before


# ---------------------------------------------------------------- model under a mesh
def _nano(n_vocab):
    cfg = JaxConfig(**NANO, n_vocab=n_vocab)
    jp = jax_init_params(cfg, jax.random.PRNGKey(3))
    model = from_jax_params(jax.tree.map(np.asarray, jp), WhisperConfig(**NANO, n_vocab=n_vocab),
                            device="cpu")
    return cfg, jp, model


@pytest.mark.parametrize("n_vocab,tp", [(51864, 2), (51864, 4), (51866, 2), (51866, 4)])
def test_sharded_decode_equals_unsharded_and_jax(n_vocab, tp):
    """Greedy fp32 tokens under a (1, tp) mesh equal the unsharded port's
    and JAX's (``tests/test_sharding.py``'s inputs), with the fp32 and the
    int8 cross- and self-KV; the vocabulary is split where it divides."""
    cfg, jp, model = _nano(n_vocab)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((4, cfg.n_mels, 64)).astype(np.float32)
    prompt = np.tile(np.asarray([[5, 6, 7, 8]]), (4, 1))
    want = np.asarray(jax_greedy_decode(jp, jnp.asarray(mel), jnp.asarray(prompt, jnp.int32),
                                        cfg, max_tokens=8).tokens)
    sharded = shard_params(model, _cpu_mesh(tp))
    assert isinstance(sharded, ShardedWhisper) and len(sharded.shards) == tp
    assert sharded.vocab_split == (n_vocab % tp == 0)
    for kvq, skvq in ((False, False), (True, False), (True, True)):
        one, many = (greedy_decode(m, torch.from_numpy(mel), torch.from_numpy(prompt),
                                   max_tokens=8, kv_quant=kvq, self_kv_quant=skvq).tokens.numpy()
                     for m in (model, sharded))
        np.testing.assert_array_equal(many, one)
        if not kvq:
            np.testing.assert_array_equal(many, want)


@pytest.mark.parametrize("tp", [2, 4])
def test_w8a8_encoder_bit_equal_across_tp(tp):
    """The W8A8 encoder (int8 weights, per-row int8 activations) under a
    (1, tp) mesh gives the one-rank encoder's bits, with either attention
    kernel: global row scales and an exact int32 sum before the epilogue.
    The whole W8A8 + int8-KV + int8-logits decode gives its tokens."""
    _, _, model = _nano(51864)
    quantize_params(model)
    quantize_logits_emb(model)
    sharded = shard_params(model, _cpu_mesh(tp))
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 80, 64)).astype(np.float32))
    for attn in ("btd", "bhtd"):
        assert torch.equal(encoder_forward(sharded, mel, w8a8=True, attn=attn),
                           encoder_forward(model, mel, w8a8=True, attn=attn))
    prompt = torch.tensor([[5, 6, 7, 8]] * 3)
    one, many = (greedy_decode(m, mel, prompt, max_tokens=8, kv_quant=True, self_kv_quant=True,
                               w8a8=True).tokens for m in (model, sharded))
    assert torch.equal(one, many)


def test_shard_params_splits_like_the_specs():
    """Column-parallel weights split their output columns, row-parallel ones
    their input rows (the scale replicated), biases of row-parallel layers
    replicate; QTensor payloads and scales split with their weight."""
    _, _, model = _nano(51866)
    quantize_params(model)
    quantize_logits_emb(model)
    a = model.encoder.blocks[0].attn
    s0, s1 = shard_params(model, _cpu_mesh(2)).shards
    b0, b1 = s0.encoder.blocks[0].attn, s1.encoder.blocks[0].attn
    assert torch.equal(torch.cat([b0["wq"].q, b1["wq"].q], 1), a["wq"].q)
    assert torch.equal(torch.cat([b0["wq"].s, b1["wq"].s], 1), a["wq"].s)
    assert torch.equal(torch.cat([b0["bq"], b1["bq"]]), a["bq"])
    assert torch.equal(torch.cat([b0["wo"].q, b1["wo"].q], 0), a["wo"].q)
    assert torch.equal(b0["wo"].s, a["wo"].s) and torch.equal(b1["bo"], a["bo"])
    q8 = model.decoder.tok_emb_q8
    assert torch.equal(torch.cat([s0.decoder.tok_emb_q8.s, s1.decoder.tok_emb_q8.s]), q8.s)
    assert s0.decoder.tok_emb.shape == (51866 // 2, 64)


# ---------------------------------------------------------------- the TP engine
class IdTok:
    def __init__(self):
        self.non_speech_tokens = get_tokenizer(num_languages=99).non_speech_tokens

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


OPTS = dict(max_slots=4, steps_per_sync=2, max_tokens=8, kv_quant=True, self_kv_quant=True,
            no_speech_threshold=None, logprob_threshold=None, compression_ratio_threshold=None)


def test_tp_engine_equals_unsharded_port_and_jax():
    """test-nano, fp32, int8 cross- and self-KV, 3 clips: the engine on a (1, 2) CPU mesh gives the tp = 1 port engine's
    tokens and the unsharded JAX engine's. Its slot caches hold each rank's
    local head."""
    jp = jax_init_params(jax_get_config("test-nano"), jax.random.PRNGKey(0))
    cfg = get_config("test-nano")
    rng = np.random.default_rng(21)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (0.6, 2.5, 1.2)]

    def port(mesh):
        model = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        return ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32, mesh=mesh,
                                        **OPTS)

    engines = {"tp1": port(None), "tp2": port(_cpu_mesh(2)),
               "jax": JaxEngine(jp, jax_get_config("test-nano"), IdTok(),
                                compute_dtype=jnp.float32, **OPTS)}
    assert [c.q.shape[2] for c in engines["tp2"].kv] == [1, 1]
    futs = {name: [] for name in engines}
    for name, eng in engines.items():
        req = Request if name != "jax" else JaxRequest
        futs[name] = [eng.submit(req(audio=c, language="zh")) for c in clips]
    for _ in range(40):
        if all(f.done() for fs in futs.values() for f in fs):
            break
        for eng in engines.values():
            eng._tick()
    texts = {name: [f.result(0)["text"] for f in fs] for name, fs in futs.items()}
    assert texts["tp2"] == texts["tp1"] == texts["jax"]


def test_engine_refuses_data_parallel_mesh():
    """The engine now takes a mesh with data rows, as the JAX engine does,
    and runs its slots on row 0: on a (2, 1) CPU mesh it gives the
    unsharded engine's texts (the name is from when it refused one)."""
    jp = jax_init_params(jax_get_config("test-nano"), jax.random.PRNGKey(0))
    cfg = get_config("test-nano")
    rng = np.random.default_rng(22)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (0.6, 2.5, 1.2)]
    texts = []
    for mesh in (None, _cpu_mesh(1, n_data=2)):
        model = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        eng = ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32, mesh=mesh,
                                       **OPTS)
        assert not isinstance(eng.model, DataParallelWhisper)
        futs = [eng.submit(Request(audio=c, language="zh")) for c in clips]
        for _ in range(40):
            if all(f.done() for f in futs):
                break
            eng._tick()
        texts.append([f.result(0)["text"] for f in futs])
    assert texts[1] == texts[0]


# ---------------------------------------------------------------- data rows
def _setup():
    """``tests/test_sharding.py``'s inputs on the port's nano-shard model:
    4 clips, prompt [5, 6, 7, 8], and the unsharded JAX greedy tokens."""
    cfg, jp, model = _nano(51864)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((4, cfg.n_mels, 64)).astype(np.float32)
    prompt = np.tile(np.asarray([[5, 6, 7, 8]]), (4, 1))
    return cfg, jp, model, mel, prompt


def _jax_on_mesh(mesh, jp, cfg, mel, prompt):
    """JAX params and inputs placed on a JAX mesh as ``tests/test_sharding.py``
    places them."""
    ds = js.data_specs()
    return (js.shard_params(jp, mesh, cfg),
            jax.device_put(jnp.asarray(mel), NamedSharding(mesh, ds["mel"])),
            jax.device_put(jnp.asarray(prompt, jnp.int32), NamedSharding(mesh, ds["tokens"])))


@pytest.mark.parametrize("n_data,tp", [(4, 2), (2, 4), (4, 1), (1, 2)])
def test_data_mesh_greedy_equals_unsharded_and_jax_mesh(n_data, tp):
    """Greedy fp32 tokens on an (n_data, tp) port mesh equal the unsharded
    port's and JAX's ``greedy_decode`` on a JAX mesh of the same shape,
    with the fp32 and the int8 caches; each data row holds its own split
    and its block of the caches."""
    cfg, jp, model, mel, prompt = _setup()
    sp, mel_s, prompt_s = _jax_on_mesh(_jax_mesh(n_data, tp), jp, cfg, mel, prompt)
    want = np.asarray(jax_greedy_decode(sp, mel_s, prompt_s, cfg, max_tokens=8).tokens)
    sharded = shard_params(model, _cpu_mesh(tp, n_data))
    if n_data > 1:
        assert isinstance(sharded, DataParallelWhisper) and len(sharded.rows) == n_data
        assert all(len(r.shards) == tp for r in sharded.rows)
        cross = encode_cross_kv(sharded, torch.from_numpy(mel))
        assert isinstance(cross, DataRows) and [c[0].shape[1] for c in
                                                (r if tp == 1 else r[0] for r in cross)] == \
            [4 // n_data] * n_data
    for kvq, skvq in ((False, False), (True, True)):
        one, many = (greedy_decode(m, torch.from_numpy(mel), torch.from_numpy(prompt),
                                   max_tokens=8, kv_quant=kvq, self_kv_quant=skvq).tokens.numpy()
                     for m in (model, sharded))
        np.testing.assert_array_equal(many, one)
        if not kvq:
            np.testing.assert_array_equal(many, want)


def test_data_mesh_beam_equals_unsharded_and_jax_mesh():
    """Beam 2 at (4, 2): each data row holds whole utterances' beams, so the
    reorder stays inside its row."""
    cfg, jp, model, mel, prompt = _setup()
    sp, mel_s, prompt_s = _jax_on_mesh(_jax_mesh(4, 2), jp, cfg, mel, prompt)
    want = np.asarray(jax_beam_search(sp, mel_s, prompt_s, cfg, beam_size=2,
                                      apply_filters=False, max_tokens=6).tokens)
    sharded = shard_params(model, _cpu_mesh(2, 4))
    for m in (model, sharded):
        got = beam_search(m, torch.from_numpy(mel), torch.from_numpy(prompt), beam_size=2,
                          apply_filters=False, max_tokens=6).tokens.numpy()
        np.testing.assert_array_equal(got, want)


def test_data_mesh_spec_and_detection_equal_unsharded_and_jax():
    """At (2, 2): the self-draft speculative decode (gamma 2) gives the
    unsharded greedy tokens and JAX's speculative decode; detection gives
    JAX's languages and probabilities."""
    cfg, jp, model, mel, prompt = _setup()
    jcross = jax_encode_cross_kv(jp, jnp.asarray(mel), cfg)
    jspec = jax_speculative_decode_kv(jp, jcross, jp, jcross, jnp.asarray(prompt, jnp.int32),
                                      cfg, cfg, gamma=2, max_tokens=8)
    jidx, jprobs = jax_detect_language_kv(jp, jcross, cfg)
    sharded = shard_params(model, _cpu_mesh(2, 2))
    greedy = greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompt),
                           max_tokens=8).tokens
    for m in (model, sharded):
        cross = encode_cross_kv(m, torch.from_numpy(mel))
        spec = speculative_decode_kv(m, cross, m, cross, torch.from_numpy(prompt), gamma=2,
                                     max_tokens=8)
        assert torch.equal(spec.tokens, greedy)
        np.testing.assert_array_equal(spec.tokens.numpy(), np.asarray(jspec.tokens))
        assert int(spec.accepted) == int(jspec.accepted)
        idx, probs = detect_language_kv(m, cross)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-6)


def test_data_mesh_alignment_matrix_equals_unsharded():
    """The alignment pass at (2, 2) on teacher-forced tokens: each data row
    reduces its block; within 1e-5 of the unsharded matrix (two ranks'
    head sums added on the lead device)."""
    cfg, _, model, mel, _ = _setup()
    sharded = shard_params(model, _cpu_mesh(2, 2))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 1000, (4, 9)))
    head_mask = torch.zeros((cfg.n_text_layer, cfg.n_text_head))
    head_mask[1] = 1.0
    row_mask = torch.zeros((4, 9), dtype=torch.bool)
    row_mask[:, 3:8] = True
    frame_len = torch.tensor([32, 20, 32, 9])
    outs = [alignment_matrix(m, tokens, encode_cross_kv(m, torch.from_numpy(mel)), head_mask,
                             row_mask, frame_len) for m in (model, sharded)]
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_data,tp", [(2, 1), (2, 2)])
def test_w8a8_encoder_bit_equal_across_data_rows(n_data, tp):
    """The W8A8 encoder with data rows gives the unsharded encoder's bits
    (K8q quantizes per row, so a data split changes no scale), with either
    attention kernel; the W8A8 + int8-KV decode gives its tokens."""
    _, _, model = _nano(51864)
    quantize_params(model)
    quantize_logits_emb(model)
    sharded = shard_params(model, _cpu_mesh(tp, n_data))
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 80, 64)).astype(np.float32))
    for attn in ("btd", "bhtd"):
        assert torch.equal(encoder_forward(sharded, mel, w8a8=True, attn=attn),
                           encoder_forward(model, mel, w8a8=True, attn=attn))
    prompt = torch.tensor([[5, 6, 7, 8]] * 4)
    one, many = (greedy_decode(m, mel, prompt, max_tokens=8, kv_quant=True, self_kv_quant=True,
                               w8a8=True).tokens for m in (model, sharded))
    assert torch.equal(one, many)


def test_data_mesh_refuses_an_uneven_batch():
    """A batch the data rows do not divide is refused, as JAX's
    ``device_put`` of a data-sharded array refuses it; a beam step splits by
    whole utterances; caches and cross-KV must come per data row."""
    _, _, model, mel, prompt = _setup()
    mesh = _cpu_mesh(2, 4)
    sharded = shard_params(model, mesh)
    mel4, prompt4 = torch.from_numpy(mel), torch.from_numpy(prompt)
    with pytest.raises(ValueError, match="a batch of 3 rows does not split over 4 data rows"):
        greedy_decode(sharded, mel4[:3], prompt4[:3], max_tokens=4)
    two = shard_params(model, _cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="in whole groups of 4"):
        decoder_forward(two, prompt4[:, :1], 0, None, None, beam_k=4)
    with pytest.raises(TypeError, match="DataRows"):
        decoder_forward(sharded, prompt4, 0, new_kv_cache(model, 4),
                        encode_cross_kv(sharded, mel4))


def test_serving_mesh_places(monkeypatch):
    """``distributed.serving_mesh(tp)`` puts the host's cards beyond ``tp``
    on the DATA axis; ``shard_params`` now places that mesh (run with a
    count of 4 cards and their devices stood in for by the CPU)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(distributed, "make_mesh", lambda n_data, n_model: make_mesh(
        n_data, n_model, devices=["cpu"] * (n_data * n_model)))
    _, _, model = _nano(51864)
    for tp, rows in ((1, 4), (2, 2), (4, 1)):
        mesh = distributed.serving_mesh(tp)
        assert mesh.shape == {DATA_AXIS: rows, MODEL_AXIS: tp}
        placed = shard_params(model, mesh)
        assert isinstance(placed, DataParallelWhisper if rows > 1 else ShardedWhisper)


def test_main_refuses_tp_without_cards(monkeypatch):
    """``--tp N`` needs N CUDA cards: refused on the CPU and with one card."""
    assert serve_main(["--device", "cpu", "--model_type", "test-nano", "--tp", "2"]) != 0
    with pytest.raises(ValueError, match="CUDA"):
        build_engine(parse_args(["--device", "cpu", "--model_type", "test-nano", "--tp", "2"]))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="CUDA cards"):
        make_mesh(1, 2)
