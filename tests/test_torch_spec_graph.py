"""Speculative decoding in captured rounds (CPU, fp32): the counterpart of
the JAX package's compiled ``lax.while_loop`` in ``spec_decode.py``.

The configurations are tests/test_torch_spec_decode.py's (a 2-layer target,
a 1-layer draft of half its width, random, self and near drafts). A CUDA
graph cannot be captured here; as in tests/test_torch_decode_graph.py the
captured path is rehearsed with ``_Replaying``, whose replay runs the
captured group of rounds again and fails if it reads any storage its first
run did not (a graph would still read the first run's). The rehearsed
rounds must equal the uncaptured rounds bit for bit (tokens, lengths,
avg_logprob, no_speech_prob and every count), and JAX's
``speculative_decode_kv`` with test_torch_spec_decode.py's tolerances:
tokens, lengths and ``accepted`` / ``drafted`` / ``rounds`` equal,
``no_speech_prob`` within 1e-5, ``avg_logprob`` within 1e-5 with float
caches and rtol 1e-4 with the int8 ones.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_decode_graph import _Replaying
from test_torch_spec_decode import (
    DRAFT,
    NANO,
    PDRAFT,
    PNANO,
    _assert_equal_results,
    _bridge,
    _jax_run,
    _near,
    _prompt,
)
from test_torch_spec_pipeline import CFG as SPEC_CFG
from test_torch_spec_pipeline import _assert_same, _clips, _pipelines
from whisper_tpu.models import model as jm
from whisper_tpu_torch import decode as td
from whisper_tpu_torch import spec_decode as ts
from whisper_tpu_torch.decode import encode_cross_kv
from whisper_tpu_torch.models.model import DataParallelWhisper, ShardedWhisper
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
from whisper_tpu_torch.spec_decode import speculative_decode_kv

torch.set_num_threads(2)

FIELDS = ("tokens", "lengths", "avg_logprob", "no_speech_prob", "accepted", "drafted")


@pytest.fixture
def rehearsed(monkeypatch):
    """The captured path on the CPU: every decode owner's graphs rehearsed."""
    monkeypatch.setattr(td, "GraphSet", _Replaying)


@pytest.fixture(scope="module")
def trees():
    """name -> (JAX config, JAX params, port config)."""
    target = jm.init_params(NANO, jax.random.PRNGKey(0))
    return {"target": (NANO, target, PNANO),
            "random": (DRAFT, jm.init_params(DRAFT, jax.random.PRNGKey(7)), PDRAFT),
            "self": (NANO, target, PNANO),
            "near": (NANO, _near(target), PNANO)}


def _models(trees):
    """name -> (config, JAX params, a port model of its own): a target's
    captured loops are per model, and these tests count them."""
    return {name: (cfg, *_bridge(jp, pcfg)) for name, (cfg, jp, pcfg) in trees.items()}


def _mel(seed, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, NANO.n_mels, 2 * NANO.n_audio_ctx)).astype(np.float32)


def _run(models, mel, draft, gamma, max_tokens, quant, graphed):
    """The port's rounds, graphed (rehearsed) or uncaptured, against the
    draft of that name (or a port model)."""
    _, _, model = models["target"]
    dmodel = models[draft][2] if isinstance(draft, str) else draft
    m = torch.from_numpy(mel)
    return ts._spec_rounds(model, encode_cross_kv(model, m, kv_quant=quant), dmodel,
                           encode_cross_kv(dmodel, m, kv_quant=quant),
                           torch.from_numpy(_prompt(NANO)).long(), gamma, torch.float32,
                           max_tokens, quant, 0, "erf", "fd", graphed)


def _assert_bit_equal(got, want):
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got[6:] == want[6:]  # rounds, host_syncs, device_rounds


# name: (draft, gamma, token budget, int8 cross- and self-KV, rounds a group
# or None for SPEC_ROUNDS)
CASES = {
    "random-g4-t12-r4": ("random", 4, 12, False, 4),  # 11 rounds: the last group masks one
    "random-g2-t10-int8": ("random", 2, 10, True, None),
    "random-g3-t1-r4": ("random", 3, 1, False, 4),  # every row done at the prefill
    "self-g3-t16-int8-r3": ("self", 3, 16, True, 3),
    "near-g4-t16": ("near", 4, 16, False, None),
    "near-g3-t9-int8-r3": ("near", 3, 9, True, 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_spec_rounds_graphed_equal_jax(rehearsed, trees, case, monkeypatch):
    """Each draft and cache kind, in groups of one round and of several:
    the rehearsed rounds bit-equal to the uncaptured ones and equal to
    JAX's; one flag read a group, whole groups on the device, the masked
    rounds of the last group counted nowhere."""
    draft, gamma, budget, quant, group = CASES[case]
    if group:
        monkeypatch.setattr(ts, "SPEC_ROUNDS", group)
    R = ts.SPEC_ROUNDS
    models = _models(trees)
    mel = _mel(0)
    ref = _jax_run(models, mel, draft, gamma, budget, quant)
    got = _run(models, mel, draft, gamma, budget, quant, graphed=True)
    _assert_bit_equal(got, _run(models, mel, draft, gamma, budget, quant, graphed=False))
    _assert_equal_results(got, ref, quant)
    assert got.host_syncs == max(1, -(-got.rounds // R))
    assert got.device_rounds == got.host_syncs * R
    stats = td.graph_stats(models["target"][2])
    assert stats["keys"] == 1 and stats["replays"] == got.host_syncs - 1
    if group:  # a masked tail ran
        assert got.device_rounds > got.rounds
    if budget == 1:
        assert got.rounds == 0 and got.host_syncs == 1


def test_spec_rounds_graphed_at_the_ctx_edge(rehearsed, monkeypatch):
    """``max_tokens=None`` at ``n_text_ctx = 16``, gamma 1 (the test of
    test_torch_spec_decode.py), in groups of 4: the windows' writes cross
    the cache's end and are dropped in the rehearsed rounds too, masked
    rounds wholly past it included; equal to the uncaptured rounds and to
    JAX's, counts included."""
    monkeypatch.setattr(ts, "SPEC_ROUNDS", 4)
    cfg16 = dataclasses.replace(NANO, name="nano-spec16", n_text_ctx=16)
    d16 = dataclasses.replace(DRAFT, name="nano-draft16", n_text_ctx=16)
    p16 = dataclasses.replace(PNANO, name="nano-spec16", n_text_ctx=16)
    pd16 = dataclasses.replace(PDRAFT, name="nano-draft16", n_text_ctx=16)
    models = {"target": (cfg16, *_bridge(jm.init_params(cfg16, jax.random.PRNGKey(3)), p16)),
              "random": (d16, *_bridge(jm.init_params(d16, jax.random.PRNGKey(11)), pd16))}
    mel = _mel(0)
    ref = _jax_run(models, mel, "random", 1, None, False, cfg=cfg16)
    got = _run(models, mel, "random", 1, None, False, graphed=True)
    _assert_bit_equal(got, _run(models, mel, "random", 1, None, False, graphed=False))
    _assert_equal_results(got, ref, False)
    assert got.device_rounds == got.host_syncs * 4 > got.rounds


def test_spec_replays_other_audio_and_keys_on_the_draft(rehearsed, trees):
    """A second call on other audio replays with no new capture, and its
    result is its own (the first one's tensors untouched). The same target
    with another draft, and back: one key a draft (its decoder weights'
    pointers), each result equal to its uncaptured run."""
    models = _models(trees)
    target = models["target"][2]
    runs = [("near", 0), ("near", 1), ("random", 1), ("near", 2)]
    out = []
    for draft, seed in runs:
        got = _run(models, _mel(seed), draft, 3, 12, True, graphed=True)
        out.append((got, got.tokens.clone(), got.accepted.clone()))
        _assert_bit_equal(got, _run(models, _mel(seed), draft, 3, 12, True, graphed=False))
        if len(out) == 2:  # the second call on other audio: replays only
            stats = td.graph_stats(target)
            assert stats["keys"] == stats["captures"] == 1
            assert stats["replays"] == out[0][0].host_syncs + out[1][0].host_syncs - 1
    assert all(torch.equal(got.tokens, toks) and torch.equal(got.accepted, acc)
               for got, toks, acc in out)
    assert not torch.equal(out[0][0].tokens, out[1][0].tokens)
    stats = td.graph_stats(target)
    assert stats["keys"] == stats["captures"] == 2  # near and random; near's again replays
    owner = td._GRAPHS[target]
    pointers = {k[2] for k in owner.loops}
    assert pointers == {td._decoder_pointers(models["near"][2]),
                        td._decoder_pointers(models["random"][2])}


def test_pipeline_spec_graphed_twice_equals_jax(rehearsed, monkeypatch):
    """``transcribe_batch`` with a draft, in captured rounds (rehearsed),
    twice on the same clips: both equal the JAX pipeline's (texts, tokens,
    languages, its ``last_spec_stats`` counts); the second call captures
    nothing and replays every group."""
    monkeypatch.setattr(ts, "capturable", lambda model, device: True)
    target = jm.init_params(SPEC_CFG, jax.random.PRNGKey(3))
    jpipe, tpipe = _pipelines((target, _near(target)))
    clips = _clips(21, (2.0, 5.0, 1.0))
    want = jpipe.transcribe_batch(clips)
    first = tpipe.transcribe_batch(clips)
    _assert_same(first, want, tpipe, jpipe)
    stats = td.graph_stats(tpipe.model)
    second = tpipe.transcribe_batch(clips)
    _assert_same(second, want, tpipe, jpipe)
    again = td.graph_stats(tpipe.model)
    assert again["keys"] == stats["keys"] == again["captures"] == 1
    assert again["replays"] - stats["replays"] == tpipe.last_spec_stats["host_syncs"]


def test_cpu_spec_decodes_capture_nothing(trees, monkeypatch):
    """On the CPU ``speculative_decode_kv`` takes the uncaptured rounds; on
    the card it captures them for a single-device target and draft, and a
    draft that is not a single-device ``Whisper`` (a mesh's) keeps them
    uncaptured."""
    models = _models(trees)
    _, _, model = models["target"]
    _, _, dmodel = models["random"]
    m = torch.from_numpy(_mel(4))
    res = speculative_decode_kv(model, encode_cross_kv(model, m), dmodel,
                                encode_cross_kv(dmodel, m),
                                torch.from_numpy(_prompt(NANO)).long(), gamma=2, max_tokens=6)
    assert td.graph_stats(model) is None and res.host_syncs >= 1
    sharded = shard_params(from_jax_params(jax.tree.map(np.asarray, trees["random"][1]), PDRAFT,
                                           device="cpu"), make_mesh(1, 2, devices=["cpu", "cpu"]))
    seen = []
    monkeypatch.setattr(ts, "_spec_rounds", lambda *a: seen.append(a[-1]))
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))  # the choice reads no more
    for draft in (dmodel, sharded):
        speculative_decode_kv(model, None, draft, None, on_card)
    assert seen == [True, False]


def test_spec_capture_choice_one_card_mesh(monkeypatch):
    """A target and a draft under meshes whose ranks all lie on the card
    are captured; a draft with a rank on another card, or a target whose
    ranks are not on the prompt's card, keeps the rounds uncaptured.
    Stand-in ranks on the cards: the choice reads their devices, no card
    is needed."""
    def ranks(*cards):
        return ShardedWhisper(PNANO, [types.SimpleNamespace(device=torch.device("cuda", c))
                                      for c in cards])

    seen = []
    monkeypatch.setattr(ts, "_spec_rounds", lambda *a: seen.append(a[-1]))
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    rows = DataParallelWhisper(PNANO, [ranks(0, 0), ranks(0, 0)], None)
    for target, draft in ((ranks(0, 0), ranks(0, 0)), (rows, ranks(0)), (ranks(0, 0), rows),
                          (ranks(0, 0), ranks(0, 1)), (ranks(1, 1), ranks(0, 0)),
                          (rows, DataParallelWhisper(PNANO, [ranks(0), ranks(1)], None))):
        speculative_decode_kv(target, None, draft, None, on_card)
    assert seen == [True, True, True, False, False, False]
