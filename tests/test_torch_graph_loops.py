"""The sampled decode, the temperature ladder and beam search in captured
rounds (CPU, test-nano, fp32): the counterparts of the JAX package's
compiled sampled and beam loops.

A CUDA graph cannot be captured here. As in tests/test_torch_decode_graph.py
the captured path is rehearsed with ``_Replaying``: its replay runs the
captured round again and fails if it reads any storage its first run did
not (a graph would still read the first run's). The sampled rounds run
under the JAX package's own Gumbel draws (``jax_gumbel``), so their tokens
are held against JAX's ``greedy_decode_kv`` at temperature > 0; the beam
rounds against JAX's ``beam_search_kv``, on weights leaning towards eot so
that beams finish (tests/test_torch_beam.py) and, for the early exit, so
that every utterance finishes long before the budget and the last round
runs masked steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_beam import EOT_BIAS, assert_equal_results
from test_torch_beam import _prompts as beam_prompts
from test_torch_decode_graph import _Replaying
from test_torch_ladder import jax_gumbel
from whisper_tpu.beam import beam_search_kv as jax_beam_search_kv
from whisper_tpu.config import get_config
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import beam as tb
from whisper_tpu_torch import decode as td
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import ROUND_STEPS, encode_cross_kv
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
SUPPRESS = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
MAX_TOKENS = 13  # two rounds of 8, the last with a masked tail of 4
EARLY_EOT_BIAS = 0.3  # every utterance's beams finish within a few tokens


@pytest.fixture
def rehearsed(monkeypatch):
    """The captured path on the CPU: every decode owner's graphs rehearsed."""
    monkeypatch.setattr(td, "GraphSet", _Replaying)


def _mel(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _bridged(seed=0, eot_bias=None):
    """(JAX params, a port model of their own): a model's captured loops
    are per model, and these tests count them."""
    jp = jm.init_params(CFG, jax.random.PRNGKey(seed))
    if eot_bias is None:
        return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")
    tree = jax.tree.map(np.array, jp)
    u = np.random.default_rng(0).standard_normal(CFG.n_text_state).astype(np.float32)
    tree["decoder"]["ln"]["b"] = 0.5 * u
    tree["decoder"]["tok_emb"][CFG.eot] = eot_bias * u
    return jax.tree.map(jnp.asarray, tree), from_jax_params(tree, PCFG, device="cpu")


# ------------------------------------------------------------ sampled rounds
@pytest.mark.parametrize("temperature,kv_quant", [(0.4, False), (1.0, True)])
def test_sampled_rounds_graphed_equal_jax(rehearsed, temperature, kv_quant):
    """A sampled decode in captured rounds (rehearsed) and uncaptured, each
    under JAX's draws for its seed: tokens, lengths, avg_logprob and the
    counts bit-equal between the two, and tokens and lengths equal to JAX's
    ``greedy_decode_kv`` at that temperature (avg_logprob within 1e-5).
    A second decode of other audio replays the one captured key."""
    jp, model = _bridged()
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int64), (3, 1))
    suppress = torch.from_numpy(SUPPRESS).long()
    seed = int(temperature * 1000)
    for mel_seed in (3, 4):
        mel = _mel(mel_seed, 3)
        ref = jax_greedy_decode_kv(
            jp, jax_encode_cross_kv(jp, jnp.asarray(mel), CFG, kv_quant=kv_quant),
            jnp.asarray(prompt, jnp.int32), CFG, max_tokens=MAX_TOKENS,
            suppress_ids=jnp.asarray(SUPPRESS), apply_filters=True, self_kv_quant=kv_quant,
            temperature=temperature, seed=seed)
        cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kv_quant)
        got = {graphed: td._greedy_rounds(
                   model, cross, torch.from_numpy(prompt), torch.float32, MAX_TOKENS, suppress,
                   True, kv_quant, "erf", False, None, 0, "fd", temperature, seed,
                   jax_gumbel(seed), graphed)
               for graphed in (True, False)}
        for name in ("tokens", "lengths", "avg_logprob", "no_speech_prob"):
            assert torch.equal(getattr(got[True], name), getattr(got[False], name)), name
        assert got[True][4:] == got[False][4:]  # steps, host_syncs, device_steps
        np.testing.assert_array_equal(got[True].tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got[True].lengths.numpy(), np.asarray(ref.lengths))
        np.testing.assert_allclose(got[True].avg_logprob.numpy(), np.asarray(ref.avg_logprob),
                                   rtol=0, atol=1e-5)
    stats = td.graph_stats(model)
    assert stats["keys"] == 1 and stats["replays"] == 2 * got[True].host_syncs - 1


def test_sampled_and_greedy_keys_share_the_loop(rehearsed):
    """A greedy decode and sampled ones at two temperatures on one shape:
    one loop buffer set, one key a temperature (JAX compiles one program a
    static temperature), and the greedy key keeps replaying after the
    sampled decodes gave the loop its noise buffer."""
    _, model = _bridged()
    cross = encode_cross_kv(model, torch.from_numpy(_mel(5, 2)), kv_quant=True)
    prompt = torch.tensor([CFG.sot_sequence("en")] * 2)

    def run(temperature, graphed=True):
        return td._greedy_rounds(model, cross, prompt, torch.float32, 9, None, False, True,
                                 "erf", False, None, 0, "fd", temperature, 7, None, graphed)

    greedy = run(0.0)
    for temperature in (0.6, 1.0, 0.6):
        assert torch.equal(run(temperature).tokens, run(temperature, graphed=False).tokens)
    again = run(0.0)
    assert torch.equal(greedy.tokens, again.tokens)
    owner = td._GRAPHS[model]
    assert len(owner.loops) == 1
    assert sorted(k[-1] for k in owner.graphs._graphs) == [0.0, 0.6, 1.0]
    assert owner.graphs.replays == 2  # the second 0.6 decode and the second greedy one


def test_gumbel_noise_fills_in_place():
    """``gumbel_noise``'s ``into`` writes what its draw returns, bit for
    bit, into a row of a round's buffer (the sampled rounds' fill)."""
    draw, fill = td.gumbel_noise(11, "cpu"), td.gumbel_noise(11, "cpu")
    buf = torch.zeros((3, 4, 1000))
    for step in range(3):
        fill.into(step, buf[step])
        assert torch.equal(buf[step], draw(step, (4, 1000)))
    assert torch.isfinite(buf).all()


# ---------------------------------------------------------------- beam rounds
# name: (beam size, batch, kv_quant = self_kv_quant, timestamps, row contexts,
# length penalty, eot lean)
BEAM_CASES = {
    "k3-b2": (3, 2, False, False, None, None, EOT_BIAS),
    "k5-b3-kvq-lp1": (5, 3, True, False, None, 1.0, EOT_BIAS),
    "k3-b3-kvq-timestamps": (3, 3, True, True, None, None, EOT_BIAS),
    "k2-b3-prompt": (2, 3, False, False, (6, 3, 0), None, EOT_BIAS),
    "k3-b2-kvq-timestamps-prompt-early": (3, 2, True, True, (0, 5), None, EARLY_EOT_BIAS),
    "k4-b2-early": (4, 2, False, False, None, None, EARLY_EOT_BIAS),
}


def _beam_both(weights, mel, prompts, pads, sot_index, K, kvq, ts, lp, graphed,
               max_tokens=16):
    """(the port's rounds, JAX's ``beam_search_kv``, the port's cross-KV)."""
    jp, model = weights
    jpad = None if pads is None else jnp.asarray(pads)
    tpad = None if pads is None else torch.from_numpy(pads).long()
    want = jax_beam_search_kv(jp, jax_encode_cross_kv(jp, jnp.asarray(mel), CFG, kv_quant=kvq),
                              jnp.asarray(prompts), CFG, beam_size=K, max_tokens=max_tokens,
                              suppress_ids=jnp.asarray(SUPPRESS), timestamps=ts,
                              length_penalty=lp, prompt_pad=jpad, sot_index=sot_index,
                              self_kv_quant=kvq)
    cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kvq)
    got = tb._beam_rounds(model, cross, torch.from_numpy(prompts).long(), torch.float32, K,
                          max_tokens, torch.from_numpy(SUPPRESS).long(), ts, True, lp, tpad,
                          sot_index, kvq, "erf", graphed)
    return got, want, cross


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_rounds_graphed_equal_jax(rehearsed, case):
    """Beam search in captured rounds (rehearsed): equal to JAX's
    ``beam_search_kv`` (tokens, lengths and finished sets exactly, scores
    as tests/test_torch_beam.py holds them) and bit-equal to the same
    rounds uncaptured, with and without timestamps, pads and the length
    penalty; the early cases finish every utterance before the budget, so
    their last round runs masked steps."""
    K, b, kvq, ts, context, lp, lean = BEAM_CASES[case]
    weights = _bridged(eot_bias=lean)
    prompts, pads, sot_index = beam_prompts(b, ts, context)
    mel = _mel(7, b)
    got, want, cross = _beam_both(weights, mel, prompts, pads, sot_index, K, kvq, ts, lp, True)
    assert_equal_results(weights, cross, prompts, pads, got, want, kvq)
    plain = tb._beam_rounds(weights[1], cross, torch.from_numpy(prompts).long(), torch.float32,
                            K, 16, torch.from_numpy(SUPPRESS).long(), ts, True, lp,
                            None if pads is None else torch.from_numpy(pads).long(), sot_index,
                            kvq, "erf", False)
    for name in tb.BeamResult._fields[:7]:
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    assert got[7:] == plain[7:]  # steps, host_syncs, device_steps
    if case.endswith("early"):
        assert 0 < got.steps < got.device_steps == ROUND_STEPS
        assert (got.all_scores > -5e29).all(), "an utterance kept a free finished slot"


def test_beam_replays_other_audio(rehearsed):
    """A second beam search of the same shape with other audio and pads
    replays the captured key and is still JAX's."""
    weights = _bridged(eot_bias=EOT_BIAS)
    for seed, context in ((8, (2, 5)), (9, (4, 0))):
        prompts, pads, sot_index = beam_prompts(2, False, context)
        got, want, cross = _beam_both(weights, _mel(seed, 2), prompts, pads, sot_index, 3,
                                      True, False, None, True)
        assert_equal_results(weights, cross, prompts, pads, got, want, True)
    stats = td.graph_stats(weights[1])
    assert stats["keys"] == 1 and stats["replays"] > 0


@pytest.mark.parametrize("lean", [None, EARLY_EOT_BIAS])
def test_beam_counts_rounds(monkeypatch, lean):
    """``steps`` is the trip count, ``host_syncs`` the rounds and
    ``device_steps`` rounds x ROUND_STEPS: at ROUND_STEPS 1 (a round a
    step, no masked step) the same tokens, scores and trip count come out.
    Random weights run to the budget (15 steps, two rounds); the early
    lean stops the loop at the round of its last step."""
    weights = _bridged(eot_bias=lean)
    prompts, pads, sot_index = beam_prompts(2)
    mel = _mel(10, 2)
    cross = encode_cross_kv(weights[1], torch.from_numpy(mel))

    def run():
        return tb.beam_search_kv(weights[1], cross, torch.from_numpy(prompts).long(),
                                 beam_size=3, max_tokens=16,
                                 suppress_ids=torch.from_numpy(SUPPRESS).long())

    res = run()
    monkeypatch.setattr(td, "ROUND_STEPS", 1)
    one = run()
    for name in tb.BeamResult._fields[:7]:
        assert torch.equal(getattr(res, name), getattr(one, name)), name
    assert res.steps == one.steps == one.host_syncs
    assert res.host_syncs == max(1, -(-res.steps // ROUND_STEPS))
    assert res.device_steps == res.host_syncs * ROUND_STEPS and one.device_steps == one.host_syncs
    if lean is None:
        assert res.steps == 15 and res.host_syncs == 2
    else:
        assert res.steps < 15 and res.device_steps > res.steps


# ------------------------------------------------------------- the ladder
def test_pipeline_ladder_replays(rehearsed, monkeypatch):
    """``transcribe_batch`` with the ladder on, in captured rounds
    (rehearsed): every row climbs every rung (random weights), all rungs on
    the batch's one shape. The second call captures nothing new and
    replays every key, and both calls equal an uncaptured pipeline's."""
    monkeypatch.setattr(td, "capturable", lambda model, device: True)
    kw = dict(model="test-nano", device="cpu", compute_dtype="float32", max_tokens=10,
              kv_quant=True, self_kv_quant=True, language="en", temperature_fallback=True)
    pipe = WhisperPipeline(**kw)
    rng = np.random.default_rng(12)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (2.0, 5.0, 1.0)]
    first = pipe.transcribe_batch(clips)
    stats = td.graph_stats(pipe.model)
    assert stats["keys"] == 6  # greedy and the five rungs
    second = pipe.transcribe_batch(clips)
    again = td.graph_stats(pipe.model)
    assert again["keys"] == 6 and set(again["capture_s"]) == set(stats["capture_s"])
    rounds = pipe.last_decode.host_syncs
    assert again["replays"] - stats["replays"] == rounds
    monkeypatch.undo()
    plain = WhisperPipeline(**kw).transcribe_batch(clips)
    for a, b, c in zip(first, second, plain):
        assert a.text == b.text == c.text
        np.testing.assert_array_equal(a.tokens, c.tokens)


# rows that fail the gate before each rung, by batch: every rung re-decodes
# a smaller batch, a loop shape of its own
SHRINKING = (
    [range(7), range(6), range(5), range(4), range(3)],  # rungs at B 7, 6, 5, 4, 3
    [(1, 3), (3,)],  # B 2 and 1: new shapes, the least recently used (7, 6) dropped
    [(0, 1, 2, 4, 5, 6, 7), (5,)],  # B 7 (dropped, so captured again) and B 1 at 0.4
)


def _shrinking_gate(batch: int, n: int):
    """A ``_needs_retry`` that fails the rows of ``SHRINKING[batch]``, one
    set a call, then none."""
    sets = iter(SHRINKING[batch])

    def gate(result, prompts):
        bad = np.zeros(n, dtype=bool)
        bad[list(next(sets, ()))] = True
        return bad

    return gate


def test_pipeline_ladder_shrinking_rows(rehearsed, monkeypatch):
    """The ladder as real audio drives it: each rung re-decodes only the
    rows that failed, so its batch shrinks and every rung is a loop shape
    of its own. Over three ``transcribe_batch`` calls of 8 clips
    (rehearsed) the main decode's loop and graph are never dropped (a
    batch's main decode and its five rungs fit in ``LOOP_SHAPES``), its
    rounds replay from the second call on, only the rung keys not kept
    are captured, and every call equals an uncaptured pipeline's."""
    monkeypatch.setattr(td, "capturable", lambda model, device: True)
    kw = dict(model="test-nano", device="cpu", compute_dtype="float32", max_tokens=10,
              kv_quant=True, self_kv_quant=True, language="en", temperature_fallback=True)
    pipe, plain = WhisperPipeline(**kw), WhisperPipeline(**kw)
    plain.model = pipe.model  # the same weights; the plain pipeline's decodes run uncaptured
    rng = np.random.default_rng(13)
    clips = [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32)
             for s in (2.0, 5.0, 1.0, 3.0, 1.5, 4.0, 2.5, 0.5)]
    captures, main = [], None
    for batch in range(len(SHRINKING)):
        pipe._needs_retry = _shrinking_gate(batch, len(clips))
        before = td.graph_stats(pipe.model) or {"captures": 0, "replays": 0}
        got = pipe.transcribe_batch(clips)
        owner = td._GRAPHS[pipe.model]
        keys = [k for k in owner.graphs._graphs if k[0] == len(clips)]
        assert len(keys) == 1  # the main greedy decode's
        if main is None:
            main = owner.graphs._graphs[keys[0]]
        assert owner.graphs._graphs[keys[0]] is main, "the main decode's graph was dropped"
        stats = td.graph_stats(pipe.model)
        captures.append(stats["captures"] - before["captures"])
        # a key's first round runs before its capture; every other round replays
        assert stats["replays"] - before["replays"] == pipe.last_decode.host_syncs - captures[-1]
        monkeypatch.setattr(td, "capturable", lambda model, device: False)
        plain._needs_retry = _shrinking_gate(batch, len(clips))
        want = plain.transcribe_batch(clips)
        monkeypatch.setattr(td, "capturable", lambda model, device: True)
        for a, b in zip(got, want):
            assert a.text == b.text
            np.testing.assert_array_equal(a.tokens, b.tokens)
    assert captures == [6, 2, 1]
    assert len(td._GRAPHS[pipe.model].loops) == td.LOOP_SHAPES


# ------------------------------------------------------------- the aux worker
class IdTok:
    non_speech_tokens = ()

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode


def test_aux_worker_rounds_rehearsed(monkeypatch):
    """The engine's aux worker with its sampled ladder rungs and a beam
    request in captured rounds (rehearsed; the slot rounds uncaptured):
    the replies equal an engine's whose aux decodes run uncaptured, and
    ``aux_steps_total`` counts whole rounds."""
    _, model = _bridged(eot_bias=EOT_BIAS)
    clips = [(np.random.default_rng(40 + i).standard_normal(int(16000 * s)) * 0.1)
             .astype(np.float32) for i, s in enumerate((1.5, 3.0, 2.0))]

    def serve(graphed):
        eng = ContinuousBatchingEngine(model, IdTok(), max_slots=4, compute_dtype=torch.float32,
                                       steps_per_sync=3, max_tokens=10, kv_quant=True,
                                       self_kv_quant=True, temperature_fallback=(0.4, 1.0))
        futs = [eng.submit(Request(audio=clips[0], language="en")),
                eng.submit(Request(audio=clips[1], language="en", beam_size=3)),
                eng.submit(Request(audio=clips[2], language="en", temperature=0.4))]
        for _ in range(80):
            if all(f.done() for f in futs):
                break
            eng._tick()
            eng.aux_round()
        return [f.result(0) for f in futs], eng.stats

    plain, plain_stats = serve(False)
    with monkeypatch.context() as m:
        m.setattr(td, "GraphSet", _Replaying)
        for mod in (td, tb):
            m.setattr(mod, "capturable", lambda model, device: True)
        graphed, stats = serve(True)
        owner = td.graph_stats(model)
    keys = ("text", "attempts", "temperature", "beam_size", "tokens")
    assert [{k: r.get(k) for k in keys} for r in graphed] == \
        [{k: r.get(k) for k in keys} for r in plain]
    assert stats.aux_steps_total == plain_stats.aux_steps_total
    assert stats.aux_steps_total % ROUND_STEPS == 0 and stats.aux_batches_total >= 2
    assert owner["keys"] >= 2  # a sampled rung and the beam batch at least
