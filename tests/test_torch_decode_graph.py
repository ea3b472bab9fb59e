"""The decode loops in rounds (CPU, test-nano, fp32): the round-structured
``greedy_decode_kv`` against the JAX package's, its early all-done exit
against the step-by-step loop it replaced, the captured path rehearsed with
a graph whose replay calls the captured callable again, the engine's slot
state written in place, and the launch accounting of ``utils.graphs``.

On the CPU every round runs uncaptured; a CUDA graph cannot be captured
here. The rehearsal stands in for one: its replay runs the captured
callable again and fails if it reads any storage the first run did not
(a graph would still read the first run's), so a round that picked up a
caller's tensor, or slot state rebound instead of written in place,
fails here as it would decode stale data on the card.
"""

import gc
import inspect
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from whisper_tpu.config import get_config
from whisper_tpu.decode import greedy_decode_kv as jax_greedy_decode_kv
from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import quantize_params as jax_qparams
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import decode as td
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import ROUND_STEPS, encode_cross_kv, greedy_decode_kv
from whisper_tpu_torch.models.model import (
    DataParallelWhisper,
    ShardedWhisper,
    decoder_forward,
    new_kv_cache,
)
from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.ops import decode_attention as da
from whisper_tpu_torch.ops.log10_mel import log10_mel
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.sampling import RuleState, apply_rules
from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request
from whisper_tpu_torch.utils import graphs

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
SUPPRESS = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))
COMBOS = {  # name: (quantized weights, kv_quant, self_kv_quant, w8a8)
    "plain": (False, False, False, False),
    "kvq": (False, True, False, False),
    "kvq+skvq": (False, True, True, False),
    "kvq+skvq+w8a8": (True, True, True, True),
}
# an eot lean strong enough that every row of the early-exit cases is done
# after a few tokens (tests/test_torch_beam.py leans at 0.23)
EOT_BIAS = 0.6
STATE = ("tokens", "offsets", "active", "done", "limit", "fstate", "nsp", "pads")


@pytest.fixture(scope="module")
def bridged():
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


@pytest.fixture
def own_model(bridged):
    """A model of the bridged weights of its own: the captured rounds a
    model keeps are per model, and these tests count them."""
    return from_jax_params(jax.tree.map(np.asarray, bridged[0]), PCFG, device="cpu")


def _mel(seed, b=3):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _jax_cross(jp, mel, kv_quant, monkeypatch, w8a8=False):
    monkeypatch.setenv("WHISPER_TPU_W8A8", "1" if w8a8 else "0")
    jkv = jm.compute_cross_kv(jp, jm.encoder_forward(jp, jnp.asarray(mel), CFG), CFG)
    return jm.quantize_cross_kv(jkv) if kv_quant else jkv


def _assert_like_jax(res, ref):
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(res.no_speech_prob.numpy(), np.asarray(ref.no_speech_prob),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(res.avg_logprob.numpy(), np.asarray(ref.avg_logprob),
                               rtol=1e-4, atol=1e-5)


def _assert_rounds(res, P, max_tokens):
    """A run to the budget: the trip count, one read a round, whole rounds
    on the device."""
    rounds = -(-(max_tokens - 1) // ROUND_STEPS)
    assert res.steps == max_tokens - 1
    assert res.host_syncs == rounds and res.device_steps == rounds * ROUND_STEPS


# ------------------------------------------------------------- vs JAX
@pytest.mark.parametrize("combo,max_tokens", [(c, 13) for c in COMBOS] + [("plain", 5)])
def test_rounds_equal_jax(combo, max_tokens, monkeypatch):
    """Every cache and weight combination over two rounds, and one round,
    at budgets that are not a multiple of ROUND_STEPS (the last round
    masks its tail): tokens and lengths equal to JAX's, no_speech_prob and
    avg_logprob within test_torch_decode.py's tolerances."""
    quant, kv_quant, self_kv_quant, w8a8 = COMBOS[combo]
    assert max_tokens % ROUND_STEPS
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    if quant:
        jp = jax_qparams(jp)
    model = from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")
    mel = _mel(7)
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int64), (3, 1))
    ref = jax_greedy_decode_kv(jp, _jax_cross(jp, mel, kv_quant, monkeypatch, w8a8),
                               jnp.asarray(prompt, jnp.int32), CFG, max_tokens=max_tokens,
                               suppress_ids=jnp.asarray(SUPPRESS), apply_filters=True,
                               self_kv_quant=self_kv_quant)
    cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kv_quant, w8a8=w8a8)
    res = greedy_decode_kv(model, cross, torch.from_numpy(prompt), max_tokens=max_tokens,
                           suppress_ids=torch.from_numpy(SUPPRESS).long(), apply_filters=True,
                           self_kv_quant=self_kv_quant)
    _assert_like_jax(res, ref)
    _assert_rounds(res, prompt.shape[1], max_tokens)


@pytest.mark.parametrize("combo", ["plain", "kvq+skvq"])
def test_rounds_timestamps_and_pads_equal_jax(bridged, combo, monkeypatch):
    """The timestamp grammar on right-aligned prompts with mixed left pads
    and sot_index, over 11 tokens (a masked tail of 6): equal to JAX."""
    _, kv_quant, self_kv_quant, _ = COMBOS[combo]
    jp, model = bridged
    mel = _mel(9)
    base = list(CFG.sot_sequence("en")[:-1])
    prevs = [[CFG.sot_prev, 11, 22, 33, 44, 55, 66], [CFG.sot_prev, 300], []]
    P = 1 + 6 + len(base)
    prompt = np.full((3, P), CFG.eot, np.int64)
    pads = np.full((3,), P - len(base), np.int64)
    prompt[:, -len(base):] = base
    for i, prev in enumerate(prevs):
        if prev:
            pads[i] = P - len(base) - len(prev)
            prompt[i, pads[i]: P - len(base)] = prev
    sot_index = P - len(base)
    ref = jax_greedy_decode_kv(jp, _jax_cross(jp, mel, kv_quant, monkeypatch),
                               jnp.asarray(prompt, jnp.int32), CFG, max_tokens=11,
                               suppress_ids=jnp.asarray(SUPPRESS), timestamps=True,
                               apply_filters=True, self_kv_quant=self_kv_quant,
                               prompt_pad=jnp.asarray(pads, jnp.int32), sot_index=sot_index)
    cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kv_quant)
    res = greedy_decode_kv(model, cross, torch.from_numpy(prompt), max_tokens=11,
                           suppress_ids=torch.from_numpy(SUPPRESS).long(), timestamps=True,
                           apply_filters=True, self_kv_quant=self_kv_quant,
                           prompt_pad=torch.from_numpy(pads), sot_index=sot_index)
    _assert_like_jax(res, ref)
    assert (np.asarray(ref.tokens)[:, P] >= CFG.timestamp_begin).all()  # the grammar ran
    _assert_rounds(res, P, 11)


# ------------------------------------------------------------ early exit
def _eot_leaning():
    tree = jax.tree.map(np.array, jm.init_params(CFG, jax.random.PRNGKey(0)))
    u = np.random.default_rng(0).standard_normal(CFG.n_text_state).astype(np.float32)
    tree["decoder"]["ln"]["b"] = 0.5 * u
    tree["decoder"]["tok_emb"][CFG.eot] = EOT_BIAS * u
    return jax.tree.map(jnp.asarray, tree), from_jax_params(tree, PCFG, device="cpu")


def _stepwise(model, cross, prompt, max_tokens, suppress, self_kv_quant):
    """The loop the rounds replaced: one decoder_forward(S=1) a step, the
    all-done flag read before each; (tokens, steps, reads)."""
    cfg = model.cfg
    B, P = prompt.shape
    T = cfg.n_text_ctx
    limit = min(T, P + max_tokens)
    kv = new_kv_cache(model, B, ctx=-(-limit // 128) * 128, quant=self_kv_quant)
    tokens = torch.full((B, T), cfg.eot, dtype=torch.int64)
    tokens[:, :P] = prompt

    def pick(logits, rs):
        lp = torch.log_softmax(apply_rules(logits, rs, cfg, suppress_ids=suppress), dim=-1)
        return torch.argmax(lp, dim=-1)

    logits, kv = decoder_forward(model, prompt, 0, kv, cross)
    rs = RuleState.create(B, device="cpu")
    first = pick(logits[:, -1], rs)
    rs = rs.advance(first, cfg.timestamp_begin)
    tokens[:, P] = first
    done = first == cfg.eot
    i, steps, reads = P, 0, 0
    while i < limit - 1:
        reads += 1
        if bool(done.all()):
            break
        logits, kv = decoder_forward(model, tokens[:, i:i + 1], i, kv, cross)
        nxt = torch.where(done, torch.full_like(done, cfg.eot, dtype=torch.int64),
                          pick(logits[:, 0], rs))
        done = done | (nxt == cfg.eot)
        tokens[:, i + 1] = nxt
        rs = rs.advance(nxt, cfg.timestamp_begin)
        i += 1
        steps += 1
    return tokens, steps, reads


@pytest.mark.parametrize("seed,kv_quant", [(11, False), (12, True)])
def test_early_exit_counts(seed, kv_quant, monkeypatch):
    """Eot-leaning weights: every row is done before the budget. The
    rounds stop at the round of the last eot with the step-by-step loop's
    trip count, one read a round; tokens equal the old loop's and JAX's."""
    jp, model = _eot_leaning()
    mel = _mel(seed, b=4)
    prompt = np.tile(np.asarray([CFG.sot_sequence("zh")], np.int64), (4, 1))
    max_tokens = 40
    cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kv_quant)
    suppress = torch.from_numpy(SUPPRESS).long()
    res = greedy_decode_kv(model, cross, torch.from_numpy(prompt), max_tokens=max_tokens,
                           suppress_ids=suppress, apply_filters=True, self_kv_quant=kv_quant)
    tokens, steps, reads = _stepwise(model, cross, torch.from_numpy(prompt), max_tokens,
                                     suppress, kv_quant)
    assert steps < max_tokens - 1, "the lean left a row running to the budget"
    assert res.steps == steps
    assert res.host_syncs == max(1, -(-steps // ROUND_STEPS)) < reads
    assert res.device_steps == res.host_syncs * ROUND_STEPS
    assert torch.equal(res.tokens, tokens)
    ref = jax_greedy_decode_kv(jp, _jax_cross(jp, mel, kv_quant, monkeypatch),
                               jnp.asarray(prompt, jnp.int32), CFG, max_tokens=max_tokens,
                               suppress_ids=jnp.asarray(SUPPRESS), apply_filters=True,
                               self_kv_quant=kv_quant)
    _assert_like_jax(res, ref)


# ------------------------------------------------- the captured path, rehearsed
def _tensor_leaves(x, out: list) -> list:
    """The tensors of an op's arguments or outputs, in order, appended to
    ``out`` (an op nests them only in lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensor_leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensor_leaves(y, out)
    return out


class _Reads(TorchDispatchMode):
    """The storages a callable's ops read that none of its ops made, in
    order: what a CUDA graph of it bakes in. 0-d tensors that no op made
    are Python scalars wrapped for an op (kernel arguments on the card)
    and are left out."""

    def __init__(self):
        super().__init__()
        # the ops' outputs, held so that no id is reused during the run
        self.made, self.held, self.reads = set(), [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in _tensor_leaves((args, kwargs), []):
            if t.dim() and id(t) not in self.made:
                self.reads.append(t.untyped_storage().data_ptr())
        out = func(*args, **(kwargs or {}))
        made = _tensor_leaves(out, [])
        self.held += made
        self.made.update(map(id, made))
        return out


class _Replaying(graphs.GraphSet):
    """A GraphSet whose capture keeps the callable without running it and
    whose replay runs it again, holding that it reads exactly the storages
    its first run read: a graph would read those, whatever the callable's
    Python would pick up now."""

    def _warm(self, fn):
        with _Reads() as reads:
            fn()
        self._baked = reads.reads

    def _capture(self, fn):
        baked = self._baked

        def replay():
            with _Reads() as reads:
                fn()
            assert reads.reads == baked, "a replay read storage its capture did not"

        return SimpleNamespace(replay=replay)

    def pool_bytes(self):
        return 0


def test_captured_path_rehearsed(own_model, monkeypatch):
    """``_greedy_rounds(graphed=True)`` on the CPU with the rehearsal graph:
    two calls of one shape (one capture, then replays only) with other
    audio, pads and suppress ids each give what the uncaptured rounds
    give, bit for bit; the first result is a copy the second call leaves
    alone; a sampled decode is captured under a key of its own and equals
    its uncaptured rounds under the same seed."""
    model = own_model
    monkeypatch.setattr(td, "GraphSet", _Replaying)
    P = 5
    args = []
    for seed, prev in ((21, [CFG.sot_prev, 7]), (22, [CFG.sot_prev, 9, 10, 11])):
        cross = encode_cross_kv(model, torch.from_numpy(_mel(seed)), kv_quant=True)
        prompt = np.tile(np.asarray([[CFG.eot] * 4 + [CFG.sot]], np.int64), (3, 1))
        pads = np.full((3,), P - 1, np.int64)
        prompt[0, P - 1 - len(prev): P - 1] = prev
        pads[0] = P - 1 - len(prev)
        suppress = torch.from_numpy(np.roll(SUPPRESS, seed)[:30]).long()
        args.append((cross, torch.from_numpy(prompt), suppress, torch.from_numpy(pads)))
    outs = {}
    for graphed in (True, False):
        outs[graphed] = []
        for cross, prompt, suppress, pads in args:
            outs[graphed].append(td._greedy_rounds(
                model, cross, prompt, torch.float32, 13, suppress, True, True, "erf", False,
                pads, P - 1, "fd", 0.0, 0, None, graphed))
    first = outs[True][0].tokens.clone()
    for got, want in zip(outs[True], outs[False]):
        for name in ("tokens", "lengths", "no_speech_prob", "avg_logprob"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert got[4:] == want[4:]  # steps, host_syncs, device_steps
    assert not torch.equal(outs[True][0].tokens, outs[True][1].tokens)
    assert torch.equal(outs[True][0].tokens, first)
    stats = td.graph_stats(model)
    rounds = sum(r.host_syncs for r in outs[True])
    assert stats["keys"] == 1 and stats["replays"] == rounds - 1
    sampled = [td._greedy_rounds(model, *args[0][:2], torch.float32, 13, None, False, True,
                                 "erf", False, None, 0, "fd", 0.5, 0, None, graphed)
               for graphed in (True, False)]
    assert torch.equal(sampled[0].tokens, sampled[1].tokens)
    assert td.graph_stats(model)["keys"] == 2


def test_loop_buffers_bounded(own_model, monkeypatch):
    """A model keeps the buffers of its LOOP_SHAPES latest batch shapes:
    a third shape drops the least recent one and its graph, which a return
    to that shape captures again; every decode equals the uncaptured one.
    (LOOP_SHAPES 2 here, so that three shapes overflow it.)"""
    model = own_model
    monkeypatch.setattr(td, "GraphSet", _Replaying)
    monkeypatch.setattr(td, "LOOP_SHAPES", 2)
    cross = encode_cross_kv(model, torch.from_numpy(_mel(23, b=4)), kv_quant=True)
    prompt = torch.tensor([CFG.sot_sequence("en")] * 4)

    def run(b, graphed):
        part = tuple(t[:, :b] for t in cross)
        return td._greedy_rounds(model, part, prompt[:b], torch.float32, 9, None, False, True,
                                 "erf", False, None, 0, "fd", 0.0, 0, None, graphed)

    for b in (4, 2, 1, 4):
        got, want = run(b, True), run(b, False)
        assert torch.equal(got.tokens, want.tokens) and torch.equal(got.avg_logprob,
                                                                     want.avg_logprob)
    owner = td._GRAPHS[model]
    assert [k[0] for k in owner.loops] == [1, 4]
    assert sorted(k[0] for k in owner.graphs._graphs) == [1, 4]
    assert owner.graphs.replays == 0  # 9 tokens: one round a decode, each a capture


def test_sampled_draws_stop_at_the_budget(bridged):
    """A sampled decode asks its noise hook for steps 0 .. max_tokens - 1
    only, once each, in order: the masked tail of the last round draws
    nothing, so a hook of exactly the budget's draws is enough (11 tokens:
    two rounds of 8, five steps masked)."""
    _, model = bridged
    cross = encode_cross_kv(model, torch.from_numpy(_mel(27)), kv_quant=True)
    prompt = torch.tensor([CFG.sot_sequence("en")] * 3)
    table = [torch.from_numpy(np.random.default_rng(40 + i).gumbel(size=(3, CFG.n_vocab))
                              .astype(np.float32)) for i in range(11)]
    calls = []

    def noise(step, shape):
        calls.append(step)
        return table[step]

    res = greedy_decode_kv(model, cross, prompt, max_tokens=11, temperature=0.7, noise=noise)
    assert calls == list(range(11)) and res.steps == 10 and res.device_steps == 16
    again = greedy_decode_kv(model, cross, prompt, max_tokens=11, temperature=0.7,
                             noise=lambda step, shape: table[step])
    assert torch.equal(res.tokens, again.tokens)


def test_cpu_decodes_capture_nothing(own_model):
    """On the CPU greedy_decode_kv takes the uncaptured rounds."""
    model = own_model
    cross = encode_cross_kv(model, torch.from_numpy(_mel(5)))
    prompt = torch.tensor([CFG.sot_sequence("en")] * 3)
    res = greedy_decode_kv(model, cross, prompt, max_tokens=6)
    assert td.graph_stats(model) is None and res.host_syncs == 1


# ---------------------------------------------------------------- engine
class IdTok:
    non_speech_tokens = ()

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode


def _engine(model, graphed: bool):
    eng = ContinuousBatchingEngine(model, IdTok(), max_slots=4, compute_dtype=torch.float32,
                                   steps_per_sync=3, max_tokens=10, kv_quant=True,
                                   self_kv_quant=True, adaptive_sync=True,
                                   prefill_buckets=(1, 2, 4))
    if graphed:
        eng._graphs = _Replaying(eng.device)
    return eng


def _pointers(eng) -> dict:
    out = {name: getattr(eng, name).data_ptr() for name in STATE}
    out.update({f"rs.{k}": v.data_ptr() for k, v in eng.rs._asdict().items()})
    return out


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def test_engine_state_in_place(bridged):
    """The slot state keeps its storage across admission, the step rounds,
    _deactivate and _fail_inflight; the engine with the rehearsal graphs
    (one per adaptive round size) replies as the uncaptured engine does."""
    _, model = bridged
    replies = {}
    for graphed in (False, True):
        eng = _engine(model, graphed)
        ptrs = _pointers(eng)
        futs = [eng.submit(Request(audio=c, language="en")) for c in _clips(31, (3, 5, 8, 2, 6))]
        for _ in range(60):
            if all(f.done() for f in futs):
                break
            eng._tick()
            assert _pointers(eng) == ptrs
        replies[graphed] = [f.result(0)["text"] for f in futs]
        if graphed:
            sizes = {k[1] for k in eng._graphs._graphs}
            assert sizes == {int(s) for s in eng.stats.round_sizes}
            assert eng._graphs.replays == sum(eng.stats.round_sizes.values()) - len(sizes)
        eng.submit(Request(audio=_clips(32, (4,))[0], language="en"))
        eng._tick()
        eng._tick()
        assert eng.stats.active_slots == 1
        eng._deactivate([i for i, r in enumerate(eng._slot_req) if r is not None])
        assert _pointers(eng) == ptrs and not bool(eng.active.any())
        eng._fail_inflight(RuntimeError("test"))
        assert _pointers(eng) == ptrs and not bool(eng.done.any())
    assert replies[True] == replies[False]


# ------------------------------------------------------ launch accounting
class _Counting(graphs.GraphSet):
    """A capture that runs the callable's Python (as a real capture does,
    launching nothing) and a replay that runs nothing."""

    def _warm(self, fn):
        fn()

    def _capture(self, fn):
        fn()
        return SimpleNamespace(replay=lambda: None)


def test_replay_accounting(monkeypatch):
    """The first run counts its own launches once (the warm run is real
    work), the capture's go to its tally and not to the counts, each
    replay adds the captured counts; a second key keeps its own; a capture
    that raises stores nothing and raises. The fake rounds count as the
    wrappers do (``_build.count``)."""
    for fn in graphs.kernel_wrappers():
        monkeypatch.setattr(fn, "launches", 0)
    k2, k3 = da.cross_attention_decode_fd, da.self_attention_decode_int8

    def round_of(n):
        def run():
            _build.count(k2, 2 * n)
            _build.count(k3, 3 * n)
        return run

    gs = _Counting("cpu")
    gs.run(("step", 1), round_of(1))
    assert (k2.launches, k3.launches) == (2, 3) and gs.replays == 0
    for _ in range(4):
        gs.run(("step", 1), round_of(1))
    assert (k2.launches, k3.launches) == (10, 15) and gs.replays == 4
    gs.run(("step", 2), round_of(2))
    gs.run(("step", 2), round_of(2))
    assert (k2.launches, k3.launches) == (18, 27) and gs.replays == 5
    assert set(gs.capture_seconds) == {("step", 1), ("step", 2)}
    assert all(fn.launches == 0 for fn in graphs.kernel_wrappers() if fn not in (k2, k3))

    def broken():
        _build.count(k2)
        raise RuntimeError("capture refused")

    class _Failing(_Counting):
        def _warm(self, fn):
            pass

    bad = _Failing("cpu")
    with pytest.raises(RuntimeError, match="capture refused"):
        bad.run("k", broken)
    assert "k" not in bad and bad.stats()["keys"] == 0 and k2.launches == 18


def test_capture_keeps_other_threads_launches(monkeypatch):
    """A thread that launches while another captures (the engine's encode
    thread during an aux worker's capture) keeps its launch on the counts,
    and the capture's replays add only the captured round's."""
    for fn in graphs.kernel_wrappers():
        monkeypatch.setattr(fn, "launches", 0)
    k2, k7 = da.cross_attention_decode_fd, log10_mel

    def round_with_a_neighbour():
        _build.count(k2, 4)
        other = threading.Thread(target=_build.count, args=(k7,))
        other.start()
        other.join()

    gs = _Counting("cpu")
    # the warm run counts both; during the capture only the neighbour counts
    gs.run("round", round_with_a_neighbour)
    assert (k2.launches, k7.launches) == (4, 2)
    gs.run("round", round_with_a_neighbour)  # a replay: the captured k2 only
    assert (k2.launches, k7.launches) == (8, 2)
    assert gs._graphs["round"][1] == [(k2, 4)]


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_runs_without_the_collector(enabled):
    """The cyclic garbage collector is off during a capture (a collection
    there could destroy an earlier graph, which voids the capture) and
    on during the warm run and replays; afterwards, and after a capture
    that raises, it is as the caller left it."""
    seen = []

    def round_():
        seen.append(gc.isenabled())

    def broken():
        seen.append(gc.isenabled())
        raise RuntimeError("capture refused")

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        gs = _Counting("cpu")
        gs.run("k", round_)  # the warm run, then the capture
        gs.run("k", round_)  # a replay (the fake's runs nothing)
        assert seen == [enabled, False] and gc.isenabled() == enabled
        class _Cold(_Counting):
            def _warm(self, fn):
                pass

        with pytest.raises(RuntimeError, match="capture refused"):
            _Cold("cpu").run("bad", broken)
        assert seen[2:] == [False] and gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_kernel_wrappers_cover_every_counter():
    """Every function of the ops modules that counts launches is one the
    graphs account for (a wrapper left out would lose its replays)."""
    from whisper_tpu_torch.ops import flash_attention, int8_gemm, log10_mel, quantize_rows

    counted = {id(fn) for mod in (da, flash_attention, int8_gemm, log10_mel, quantize_rows)
               for fn in vars(mod).values() if callable(fn) and hasattr(fn, "launches")}
    assert counted == {id(fn) for fn in graphs.kernel_wrappers()}


def test_capture_choice(bridged):
    """Rounds are captured on the card for a single-device Whisper, greedy,
    sampled and beam alike (a sampled round reads its draws from a buffer
    filled before it, so the choice takes no temperature): not on the CPU,
    and under a mesh only where every rank of every data row lies on the
    card asked for (``cuda`` read as card 0, as a tensor's device names it);
    a mesh over two cards, or of CPU ranks, is not captured. The choice
    reads the device objects: stand-in ranks on the cards, no card
    needed."""
    _, model = bridged
    cuda = torch.device("cuda", 0)
    assert td.capturable(model, cuda) and td.capturable(model, "cuda")
    assert not td.capturable(model, "cpu")
    assert list(inspect.signature(td.capturable).parameters) == ["model", "device"]
    mesh = shard_params(model, make_mesh(1, 2, devices=["cpu", "cpu"]))
    assert not td.capturable(mesh, cuda)
    assert not td.capturable(shard_params(model, make_mesh(2, 1, devices=["cpu", "cpu"])), cuda)
    assert _engine(model, graphed=False)._graphs is None

    def ranks(*cards):  # a data row of stand-in ranks on the given cards
        return ShardedWhisper(PCFG, [SimpleNamespace(device=torch.device("cuda", c))
                                     for c in cards])

    one_card = ranks(0, 0)
    for m in (one_card, DataParallelWhisper(PCFG, [ranks(0, 0), ranks(0, 0)], None),
              DataParallelWhisper(PCFG, [ranks(0), ranks(0)], None)):
        assert td.capturable(m, cuda) and td.capturable(m, "cuda")
        assert not td.capturable(m, "cpu") and not td.capturable(m, torch.device("cuda", 1))
    for m in (ranks(0, 1), DataParallelWhisper(PCFG, [ranks(0), ranks(1)], None),
              DataParallelWhisper(PCFG, [ranks(0, 0), ranks(0, 1)], None)):
        assert not td.capturable(m, cuda) and not td.capturable(m, torch.device("cuda", 1))
    assert td.capturable(ranks(1, 1), torch.device("cuda", 1))
