"""The JAX engine's knobs on the port's engine (CPU, test-nano, fp32, the
same bridged weights): ``apply_filters``, ``prefill_buckets``,
``warm_start``, ``warmup()`` and ``start(warm=)``, ``cold_compiles_total``,
and the server's ``--warm_start`` flag.

Engines are driven with ``_tick()`` (and the aux workers by hand) so
admissions land on the same ticks on both sides. Token ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import N_SAMPLES, get_config
from whisper_tpu.decode import greedy_decode
from whisper_tpu.models import model as jm
from whisper_tpu.ops.mel import log_mel_batch
from whisper_tpu.serving.engine import ContinuousBatchingEngine as JaxEngine
from whisper_tpu.serving.engine import Request as JaxRequest
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.parallel.sharding import make_mesh
from whisper_tpu_torch.serving.__main__ import build_engine, parse_args, worker_command
from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
# the keyword set of the JAX serving tests' engines
KNOBS = dict(max_slots=4, steps_per_sync=2, max_tokens=8, apply_filters=False,
             warm_start=True, prefill_buckets=(1, 4), adaptive_sync=True)
# the slot bookkeeping warmup() must leave bit-equal
BOOKKEEPING = ("tokens", "offsets", "active", "done", "limit", "fstate", "nsp", "pads")


class IdTok:
    """Decodes to the ids themselves, so a reply carries its tokens."""

    non_speech_tokens = ()

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    decode_with_timestamps = decode


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_params(CFG, jax.random.PRNGKey(3))


def _model(jax_params):
    return from_jax_params(jax.tree.map(np.asarray, jax_params), PCFG, device="cpu")


def _port(jax_params, **kw):
    return ContinuousBatchingEngine(_model(jax_params), IdTok(), compute_dtype=torch.float32,
                                    **kw)


def _ids(reply: dict) -> list:
    return [int(t) for t in reply["text"].split()]


def _clips(seed, seconds):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(int(16000 * s)) * 0.1).astype(np.float32) for s in seconds]


def _offline_ids(jax_params, clip, max_tokens):
    """JAX's offline greedy decode of one clip without the rules."""
    audio = np.zeros((1, N_SAMPLES), np.float32)
    audio[0, : len(clip)] = clip
    mel = log_mel_batch(jnp.asarray(audio), jnp.asarray([len(clip)], np.int32),
                        n_mels=CFG.n_mels)[..., : 2 * CFG.n_audio_ctx]
    prompt = jnp.asarray([CFG.sot_sequence("zh", "transcribe")], jnp.int32)
    ref = greedy_decode(jax_params, mel, prompt, CFG, max_tokens=max_tokens)
    return np.asarray(ref.tokens)[0, 4: np.asarray(ref.lengths)[0]].tolist()


def _run(engine, futs, limit=80):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return [f.result(0) for f in futs]
        engine._tick()
        if isinstance(engine, ContinuousBatchingEngine):
            while engine.aux_round():
                pass
        else:
            while engine._beam_pending:
                engine._run_beam_batch(engine._beam_collect())
    raise AssertionError(f"requests not done after {limit} ticks")


def _state(engine) -> dict:
    """Copies of the slot bookkeeping, device and host."""
    out = {name: getattr(engine, name).clone() for name in BOOKKEEPING}
    out.update({f"rs.{k}": v.clone() for k, v in engine.rs._asdict().items()})
    out["host"] = (list(engine._slot_req), list(engine._slot_prompt_len),
                   engine._slot_gen.copy(), engine._slot_limit_h.copy(),
                   None if engine._last_offs_h is None else engine._last_offs_h.copy())
    return out


def _assert_state_equal(before: dict, after: dict):
    for name, t in before.items():
        if name == "host":
            a, b = t, after["host"]
            assert a[:2] == b[:2]
            for x, y in zip(a[2:], b[2:]):
                assert (x is None and y is None) or np.array_equal(x, y)
            continue
        assert torch.equal(t, after[name]), name


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("timestamps", [False, True])
def test_knobs_tokens_equal_jax_engine(jax_params, timestamps):
    """The port's engine built with the JAX serving tests' keywords
    (``apply_filters=False``, ``warm_start=True``, ``prefill_buckets=(1,
    4)``, ``adaptive_sync=True``) and warmed, then driven tick for tick
    beside the JAX engine built the same way: the same ids for every clip,
    a beam request on the aux worker among them. With ``timestamps`` the
    timestamp rules still run, as in JAX."""
    clips = _clips(31, (0.6, 2.5, 1.2, 4.0, 3.0, 1.8))
    port = _port(jax_params, timestamps=timestamps, **KNOBS)
    assert port._suppress is None and port.prefill_buckets == (1, 4)
    port.warmup()
    jeng = JaxEngine(jax_params, CFG, IdTok(), compute_dtype=jnp.float32,
                     timestamps=timestamps, **KNOBS)
    beams = {4: 2}  # clip index -> beam size
    arrivals = {0: [0, 1], 2: [2, 3, 4], 3: [5]}
    got, want = [None] * len(clips), [None] * len(clips)
    for tick in range(60):
        for i in arrivals.get(tick, []):
            kw = dict(audio=clips[i], language="zh", beam_size=beams.get(i, 1))
            got[i] = port.submit(Request(**kw))
            want[i] = jeng.submit(JaxRequest(**kw))
        for eng, futs in ((port, got), (jeng, want)):
            eng._tick()
            if eng is port:
                while port.aux_round():
                    pass
            else:
                while jeng._beam_pending:
                    jeng._run_beam_batch(jeng._beam_collect())
        if tick > 3 and all(f.done() for f in got + want):
            break
    got = [f.result(0) for f in got]
    want = [f.result(0) for f in want]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert [r.get("beam_size") for r in got] == [r.get("beam_size") for r in want]
    # admissions followed the buckets: no bucket of 2 was prepared
    assert {k[1] for k in port._warm_keys if k[0] == "prepare"} <= {1, 4}


# ---------------------------------------------------------------- (b)
@pytest.mark.parametrize("mesh", [None, (1, 2)])
def test_warmup_preserves_state_and_results(jax_params, mesh):
    """The mirror of the JAX engine's test of the same name: after a warm
    start every slot-path key is warm, a decode equals the offline greedy
    path, and the slot bookkeeping is bit-equal across ``warmup()`` on a
    fresh engine and on one whose slots have served (nonzero offsets). The
    self-KV differs only at ``clamp(offset - 1, 0)`` of each slot (the
    step's write of an empty slot, overwritten at admission); the cross-KV
    not at all. Counters other than the warm's own stay. Under a (1, 2)
    mesh on the CPU each rank's shard is warmed."""
    kw = {} if mesh is None else dict(mesh=make_mesh(*mesh, devices=["cpu"] * 2))
    eng = _port(jax_params, max_slots=2, steps_per_sync=2, max_tokens=8, apply_filters=False,
                adaptive_sync=True, warm_start=True, **kw)
    fresh = _state(eng)
    eng.start()
    try:
        assert eng.stats.warmup_seconds > 0
        _assert_state_equal(fresh, _state(eng))
        P0 = len(CFG.sot_sequence("zh", "transcribe"))
        for key in [("step", 2), ("step", 4), ("step", 8), ("pack",),
                    ("prepare", 1, 0), ("prepare", 2, 0), ("admit", 1, P0), ("admit", 2, P0)]:
            assert key in eng._warm_keys, key
        assert eng.stats.cold_compiles_total == len(eng._warm_keys) == 8
        stats = eng.stats.snapshot()
        assert stats["steps_total"] == stats["ticks_total"] == stats["encode_batches_total"] == 0
        assert stats["round_sizes"] == {} and stats["detect_batches_total"] == 0
        wav = _clips(5, (0.6,))[0]
        res = eng.transcribe(wav, language="zh", timeout=60)
        assert _ids(res) == _offline_ids(jax_params, wav, 8)
        assert eng.stats.cold_compiles_total == 8
    finally:
        eng.stop()
    # a served engine: slots freed with their offsets, tokens and rule state
    before = _state(eng)
    kv_before = [t.clone() for t in _leaves(eng.kv)]
    cross_before = [t.clone() for t in _leaves(eng.cross)]
    steps = eng.stats.steps_total
    eng.warmup()
    _assert_state_equal(before, _state(eng))
    assert eng.stats.steps_total == steps
    for a, b in zip(cross_before, _leaves(eng.cross)):
        assert torch.equal(a, b)
    pos = torch.clamp(before["offsets"] - 1, min=0)
    for a, b in zip(kv_before, _leaves(eng.kv)):
        a, b = a.movedim(-1, 2), b.movedim(-1, 2)  # (L, slot, position, ...)
        keep = torch.ones(a.shape[1:3], dtype=torch.bool)
        keep[torch.arange(a.shape[1]), pos] = False
        assert torch.equal(a[:, keep], b[:, keep])


def _leaves(x):
    from whisper_tpu_torch.models.model import shard_values

    return [t for part in shard_values(x) for t in part]


def test_warmup_refuses_an_active_slot(jax_params):
    eng = _port(jax_params, max_slots=2, steps_per_sync=2, max_tokens=8, warm_start=False)
    eng.submit(Request(audio=_clips(6, (1.0,))[0], language="zh"))
    eng._tick()
    with pytest.raises(RuntimeError, match="no slot is active"):
        eng.warmup()


# ---------------------------------------------------------------- (c)
def test_partial_scatter_stays_warm_and_correct(jax_params):
    """The mirror of the JAX test: a prepared batch of 4 against 2 free
    slots is copied over two ticks under the admit key warmup() ran (the
    prepare bucket's), so ``cold_compiles_total`` does not move, and the
    rows reach their own callers."""
    eng = _port(jax_params, max_slots=4, steps_per_sync=2, max_tokens=12, apply_filters=False,
                admit_chunk=4, prefill_buckets=(1, 2, 4))
    eng.warmup()
    long_wavs = _clips(7, (0.4, 0.6))
    long_futs = [eng.submit(Request(audio=w, language="zh", max_tokens=12)) for w in long_wavs]
    eng._tick()
    assert eng.stats.active_slots == 2
    short_wavs = _clips(8, (0.3, 0.4, 0.5, 0.6))
    short_futs = [eng.submit(Request(audio=w, language="zh", max_tokens=4)) for w in short_wavs]
    cold0 = eng.stats.cold_compiles_total
    results = _run(eng, long_futs + short_futs)
    assert all(r["success"] for r in results)
    assert eng.stats.cold_compiles_total == cold0, sorted(eng._warm_keys)
    for w, r, budget in zip(long_wavs + short_wavs, results, [12, 12, 4, 4, 4, 4]):
        assert _ids(r) == _offline_ids(jax_params, w, budget), r


# ---------------------------------------------------------------- (d)
def test_start_without_warm(jax_params):
    """``start(warm=False)`` skips the warm: ``warmup_seconds`` stays 0,
    keys go warm at first use, and the reply is the offline greedy one."""
    eng = _port(jax_params, max_slots=2, steps_per_sync=2, max_tokens=8, apply_filters=False)
    assert eng.warm_start is ContinuousBatchingEngine.WARM_START_DEFAULT is True
    eng.start(warm=False)
    try:
        assert eng.stats.warmup_seconds == 0 and eng.stats.cold_compiles_total == 0
        wav = _clips(9, (0.8,))[0]
        res = eng.transcribe(wav, language="zh", timeout=60)
        assert _ids(res) == _offline_ids(jax_params, wav, 8)
    finally:
        eng.stop()
    assert eng.stats.warmup_seconds == 0
    assert {("step", 2), ("pack",), ("prepare", 1, 0), ("admit", 1, 4)} <= eng._warm_keys
    assert eng.stats.cold_compiles_total == len(eng._warm_keys)


def test_aux_keys_and_filters_on_the_aux_worker(jax_params):
    """The aux worker counts its keys and decodes with the engine's
    ``apply_filters``: a beam request's ids equal the JAX engine's beam
    worker's with the filters off (with timestamps, where the suppress
    rules would change these weights' ids)."""
    clip = _clips(10, (1.5,))[0]
    kw = dict(max_slots=2, steps_per_sync=2, max_tokens=8, apply_filters=False, timestamps=True)
    port = _port(jax_params, warm_start=False, **kw)
    jeng = JaxEngine(jax_params, CFG, IdTok(), compute_dtype=jnp.float32, **kw)
    got = _run(port, [port.submit(Request(audio=clip, language="zh", beam_size=3))])
    want = _run(jeng, [jeng.submit(JaxRequest(audio=clip, language="zh", beam_size=3))])
    assert _ids(got[0]) == _ids(want[0])
    assert {("aux_encode", 1), ("aux_beam", 1, 3, 0)} <= port._warm_keys


# ---------------------------------------------------------------- (e)
def test_warm_start_flag_parses_and_reaches_the_workers():
    """``--no-warm_start`` and ``--warm_start`` parse (the JAX server's
    flag), reach the engine through ``build_engine`` and round-trip through
    a ``--dp`` worker's command line."""
    assert parse_args([]).warm_start is True
    assert parse_args(["--warm_start"]).warm_start is True
    for flags, flag in (([], "--warm_start"), (["--no-warm_start"], "--no-warm_start")):
        args = parse_args(["--dp", "2", *flags])
        cmd = worker_command(args, 9001)
        assert flag in cmd
        assert parse_args(cmd[3:]).warm_start is args.warm_start
    engine, _ = build_engine(parse_args(["--model_type", "test-nano", "--device", "cpu",
                                         "--dtype", "float32", "--no-w8a8", "--slots", "2",
                                         "--no-warm_start"]))
    assert engine.warm_start is False and engine.apply_filters is True
