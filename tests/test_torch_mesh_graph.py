"""The decode rounds of a model under a mesh in captured rounds (CPU,
test-nano, fp32): the counterpart of the JAX package compiling the same
loops under a mesh, where XLA's SPMD partitioner inserts the collectives.

A CUDA graph cannot be captured here, and a mesh of CPU devices is never
captured (``decode.capturable``). As in tests/test_torch_decode_graph.py the
captured path is rehearsed by calling the rounds with ``graphed=True``
under ``_Replaying``, whose replay runs the captured round again and fails
if it reads any storage its first run did not (a graph would still read the
first run's): a round that picked up a caller's nested cross-KV, or a rank's
cache rebound instead of written in place, fails here as it would decode
stale data on the card.

Each decode (greedy, sampled at 0.6 under the JAX package's own Gumbel
draws, beam 2, and the self-draft speculative decode at gamma 2) runs at
the meshes (1, 2), (2, 1) and (2, 2) of CPU devices, on weights leaning
towards eot (tests/test_torch_beam.py's lean) so that beams finish and rows
end at different lengths. The rehearsed rounds must equal the uncaptured
rounds bit for bit (every tensor field and every count) on two clips' audio
(the second call replays the first call's graphs), and at (2, 2) the greedy
and beam rounds also with the int8 cross- and self-KV; the fp32 ones must
equal the JAX package's
decode on a JAX mesh of the same shape: tokens, lengths and the speculative
counts exactly, the log-probabilities, beam scores and no-speech
probabilities within 1e-5 (fp32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from test_torch_decode_graph import _Replaying
from test_torch_ladder import jax_gumbel
from test_torch_parallel import OPTS, IdTok
from whisper_tpu.beam import beam_search_kv as jax_beam_search_kv
from whisper_tpu.config import get_config
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.parallel import sharding as js
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu.spec_decode import speculative_decode_kv as jax_speculative_decode_kv
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import beam as tb
from whisper_tpu_torch import decode as td
from whisper_tpu_torch import spec_decode as ts
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import encode_cross_kv
from whisper_tpu_torch.models.model import DataRows, Shards
from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.serving import engine as te
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
SUPPRESS = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
MESHES = ((1, 2), (2, 1), (2, 2))
# where the int8 caches run too (DataRows of Shards of QKVCaches), and for
# which kinds: greedy and sampled share one loop, spec's caches are reset
# by the same code as greedy's
QUANT_MESH, QUANT_KINDS = (2, 2), ("greedy", "beam")
KINDS = ("greedy", "sampled", "beam", "spec")
B = 2            # clips: one a data row
MAX_TOKENS = 13  # two rounds of 8, the last with a masked tail
EOT_BIAS = 0.23  # tests/test_torch_beam.py's lean: beams finish inside the budget
TEMPERATURE, SEED = 0.6, 600  # a rung of the ladder, the pipeline's seed for it
BEAM, GAMMA = 2, 2
TOL = dict(rtol=0, atol=1e-5)
# each kind's tensor fields (held bit for bit graphed against uncaptured)
# and counts
FIELDS = {"greedy": ("tokens", "lengths", "avg_logprob", "no_speech_prob"),
          "beam": ("tokens", "lengths", "scores", "all_tokens", "all_scores",
                   "no_speech_prob", "avg_logprob"),
          "spec": ("tokens", "lengths", "avg_logprob", "no_speech_prob", "accepted", "drafted")}
FIELDS["sampled"] = FIELDS["greedy"]
COUNTS = {"greedy": ("steps", "host_syncs", "device_steps"),
          "beam": ("steps", "host_syncs", "device_steps"),
          "spec": ("rounds", "host_syncs", "device_rounds")}
COUNTS["sampled"] = COUNTS["greedy"]


@pytest.fixture(scope="module")
def weights():
    """(JAX params, their numpy tree) of test-nano leaning towards eot."""
    tree = jax.tree.map(np.array, jm.init_params(CFG, jax.random.PRNGKey(0)))
    u = np.random.default_rng(0).standard_normal(CFG.n_text_state).astype(np.float32)
    tree["decoder"]["ln"]["b"] = 0.5 * u
    tree["decoder"]["tok_emb"][CFG.eot] = EOT_BIAS * u
    return jax.tree.map(jnp.asarray, tree), tree


def _mel(seed):
    return np.random.default_rng(seed).standard_normal(
        (B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


PROMPT = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int64), (B, 1))


def _port_rounds(kind, model, cross, graphed: bool, quant: bool = False):
    """One decode of ``kind`` through the rounds the public entry points
    call, with the capture chosen here."""
    prompt = torch.from_numpy(PROMPT)
    suppress = torch.from_numpy(SUPPRESS).long()
    if kind in ("greedy", "sampled"):
        t = TEMPERATURE if kind == "sampled" else 0.0
        return td._greedy_rounds(model, cross, prompt, torch.float32, MAX_TOKENS, suppress, True,
                                 quant, "erf", False, None, 0, "fd", t, SEED,
                                 jax_gumbel(SEED) if t else None, graphed)
    if kind == "beam":
        return tb._beam_rounds(model, cross, prompt, torch.float32, BEAM, MAX_TOKENS, suppress,
                               False, True, None, None, 0, quant, "erf", graphed)
    return ts._spec_rounds(model, cross, model, cross, prompt, GAMMA, torch.float32, MAX_TOKENS,
                           quant, 0, "erf", "fd", graphed)


def _jax_mesh_decode(kind, jp, mel, shape):
    """The JAX package's decode of ``kind`` with its params, audio and
    prompt placed on a JAX mesh of ``shape`` (tests/test_sharding.py's
    placement)."""
    mesh = js.make_mesh(*shape, devices=jax.devices()[: shape[0] * shape[1]])
    ds = js.data_specs()
    sp = js.shard_params(jp, mesh, CFG)
    cross = jax_encode_cross_kv(sp, jax.device_put(jnp.asarray(mel),
                                                   NamedSharding(mesh, ds["mel"])), CFG)
    prompt = jax.device_put(jnp.asarray(PROMPT, jnp.int32), NamedSharding(mesh, ds["tokens"]))
    suppress = jnp.asarray(SUPPRESS)
    if kind in ("greedy", "sampled"):
        return jax_greedy_decode_kv(sp, cross, prompt, CFG, max_tokens=MAX_TOKENS,
                                    suppress_ids=suppress, apply_filters=True,
                                    temperature=TEMPERATURE if kind == "sampled" else 0.0,
                                    seed=SEED)
    if kind == "beam":
        return jax_beam_search_kv(sp, cross, prompt, CFG, beam_size=BEAM, max_tokens=MAX_TOKENS,
                                  suppress_ids=suppress, apply_filters=True)
    return jax_speculative_decode_kv(sp, cross, sp, cross, prompt, CFG, CFG, gamma=GAMMA,
                                     max_tokens=MAX_TOKENS)


def _assert_bit_equal(kind, got, want, what):
    for name in FIELDS[kind]:
        assert torch.equal(getattr(got, name), getattr(want, name)), f"{what}: {name}"
    for name in COUNTS[kind]:
        assert getattr(got, name) == getattr(want, name), f"{what}: {name}"


def _assert_like_jax(kind, got, ref):
    exact = {"greedy": ("tokens", "lengths"), "beam": ("tokens", "lengths", "all_tokens"),
             "spec": ("tokens", "lengths", "accepted", "drafted")}
    exact["sampled"] = exact["greedy"]
    for name in exact[kind]:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in set(FIELDS[kind]) - set(exact[kind]):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   **TOL, err_msg=name)
    if kind == "spec":
        assert got.rounds == int(ref.rounds)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_rounds_graphed_equal_uncaptured_and_jax_mesh(weights, monkeypatch, kind, shape):
    """The rehearsed captured rounds of ``kind`` on a ``shape`` CPU mesh:
    bit-equal to the same rounds uncaptured on two clips' audio (one
    capture, then replays only; the second clip's results differ from the
    first's, so the replay read the new cross-KV) and, at ``QUANT_MESH``
    for ``QUANT_KINDS``, with the int8 caches (a key of its own), and equal
    to the JAX decode on a JAX mesh of the same shape; the loop's buffers
    keep the mesh's nesting."""
    monkeypatch.setattr(td, "GraphSet", _Replaying)
    jp, tree = weights
    model = shard_params(from_jax_params(tree, PCFG, device="cpu"),
                         make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])))
    nested = DataRows if shape[0] > 1 else Shards
    results = []
    for seed in (31, 32):
        mel = _mel(seed)
        cross = encode_cross_kv(model, torch.from_numpy(mel))
        got = _port_rounds(kind, model, cross, graphed=True)
        _assert_bit_equal(kind, got, _port_rounds(kind, model, cross, graphed=False),
                          f"{kind} at {shape}, clip {seed}")
        _assert_like_jax(kind, got, _jax_mesh_decode(kind, jp, mel, shape))
        results.append(got)
    score = "scores" if kind == "beam" else "avg_logprob"
    assert not torch.equal(getattr(results[0], score), getattr(results[1], score))
    stats = td.graph_stats(model)
    assert stats["keys"] == stats["captures"] == 1
    assert stats["replays"] == results[0].host_syncs + results[1].host_syncs - 1
    (loop,) = td._GRAPHS[model].loops.values()
    assert all(isinstance(c, nested) for c in (loop.cross if kind != "spec" else loop.cross[0],
                                               getattr(loop, "kv", None) or loop.kv_t))

    if shape != QUANT_MESH or kind not in QUANT_KINDS:
        return
    cross = encode_cross_kv(model, torch.from_numpy(_mel(33)), kv_quant=True)
    got = _port_rounds(kind, model, cross, graphed=True, quant=True)
    _assert_bit_equal(kind, got, _port_rounds(kind, model, cross, graphed=False, quant=True),
                      f"{kind} at {shape}, int8 caches")
    assert td.graph_stats(model)["captures"] == 2


def test_tp_engine_graphed_equals_unsharded_port_and_jax(monkeypatch):
    """The engine on a (1, 2) CPU mesh with its step rounds captured
    (rehearsed: ``_graphs`` is a rehearsal graph set, which the engine made
    because the choice held), 3 clips: its replies equal the unsharded port
    engine's (uncaptured) and the JAX engine's; one graph for its one round
    size, replayed every later round."""
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (0.6, 2.5, 1.2)]

    def port(mesh):
        model = from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")
        return ContinuousBatchingEngine(model, IdTok(), compute_dtype=torch.float32, mesh=mesh,
                                        **OPTS)

    plain = port(None)
    with monkeypatch.context() as m:
        m.setattr(te, "capturable", lambda model, device: True)
        m.setattr(te, "GraphSet", _Replaying)
        graphed = port(make_mesh(1, 2, devices=["cpu", "cpu"]))
    assert isinstance(graphed._graphs, _Replaying) and plain._graphs is None
    engines = {"plain": plain, "graphed": graphed,
               "jax": JaxEngine(jp, CFG, IdTok(), compute_dtype=jnp.float32, **OPTS)}
    futs = {name: [eng.submit((JaxRequest if name == "jax" else Request)(
        audio=c, language="zh")) for c in clips] for name, eng in engines.items()}
    for _ in range(40):
        if all(f.done() for fs in futs.values() for f in fs):
            break
        for eng in engines.values():
            eng._tick()
    texts = {name: [f.result(0)["text"] for f in fs] for name, fs in futs.items()}
    assert texts["graphed"] == texts["plain"] == texts["jax"]
    stats = graphed._graphs.stats()
    assert stats["keys"] == stats["captures"] == 1
    assert stats["replays"] == graphed.stats.round_sizes[str(OPTS["steps_per_sync"])] - 1 > 0
