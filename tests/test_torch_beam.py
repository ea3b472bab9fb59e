"""Beam search of the port against the JAX package (CPU, test-nano, fp32,
the same bridged weights): ``beam_search`` / ``beam_search_kv`` over beam
sizes, batches, int8 cross- and self-KV, timestamps, right-aligned prompts
and the length penalty; ``decoder_forward(beam_k=K)``; the top-k order on
ties; and the properties ``tests/test_beam.py`` holds for the JAX package.

Random weights rarely emit eot, which would leave the finished set empty
and run every beam to the cap. So the weights here lean towards eot: the
final LayerNorm's bias is a seeded vector u and eot's embedding 0.23 u, so
eot's logit grows with u's share of the decoder state. At that strength
some utterances finish after a few tokens, others at the cap, which runs
both the finished set (retire, top K of 3K, ties at ``NEG_INF``) and the
fallback to the best running beam.

Tokens, lengths and the finished sets must be equal. Scores and
no-speech probabilities agree within 1e-5; with the int8 cross-KV within
the greedy tests' tolerance (rtol 1e-4, atol 1e-5), since a cross-KV value
at a rounding tie quantizes one level apart (the greedy avg_logprob differs
by up to 3.3e-5 there too). A token difference is reported with its row,
step and the candidate margin there (the log-prob gap between the two
tokens after the shared prefix).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.beam import beam_search as jax_beam_search
from whisper_tpu.beam import beam_search_kv as jax_beam_search_kv
from whisper_tpu.config import get_config
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.models import model as jm
from whisper_tpu.sampling import NEG_INF
from whisper_tpu.sampling import build_suppress_ids as jax_suppress_ids
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch.beam import BeamResult, _top_k, beam_search, beam_search_kv
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import ROUND_STEPS, encode_cross_kv, greedy_decode, index_cross_kv
from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.sampling import RuleState, apply_rules

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
EOT_BIAS = 0.23
MAX_TOKENS = 16
SUPPRESS = jax_suppress_ids(CFG, jax_tokenizer(num_languages=CFG.num_languages))


def eot_leaning(jp):
    """(JAX params, the port's model) of ``jp`` with the eot lean of the
    module docstring."""
    tree = jax.tree.map(np.array, jp)
    u = np.random.default_rng(0).standard_normal(CFG.n_text_state).astype(np.float32)
    tree["decoder"]["ln"]["b"] = 0.5 * u
    tree["decoder"]["tok_emb"][CFG.eot] = EOT_BIAS * u
    return jax.tree.map(jnp.asarray, tree), from_jax_params(tree, PCFG, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return eot_leaning(jm.init_params(CFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def plain_weights():
    """The unleaning weights, whose beams run to the cap."""
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


def _mel(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _prompts(b, timestamps=False, context=None):
    """(prompts (b, P) int32, pads (b,) or None, sot_index): the sot
    sequence, or with ``context`` (tokens a row) right-aligned
    ``[pad..., sot_prev, context..., sot sequence]`` rows over the longest
    context, as the seek loop builds them (a row without context keeps its
    pad at sot)."""
    seq = list(CFG.sot_sequence("zh"))
    if timestamps:
        seq = seq[:-1]
    if context is None:
        return np.tile(np.asarray([seq], np.int32), (b, 1)), None, 0
    width = max(context)
    P = 1 + width + len(seq)
    prompts = np.full((b, P), CFG.eot, np.int32)
    pads = np.full((b,), P - len(seq), np.int32)
    prompts[:, -len(seq):] = seq
    for j, n in enumerate(context[:b]):
        if n:
            pads[j] = width - n
            prompts[j, pads[j]] = CFG.sot_prev
            prompts[j, pads[j] + 1: pads[j] + 1 + n] = 200 + 37 * j + np.arange(n)
    return prompts, pads, P - len(seq)


# name: (beam size, batch, kv_quant, self_kv_quant, timestamps, row contexts,
# length_penalty, entry point)
CASES = {
    "k2-b1": (2, 1, False, False, False, None, None, "mel"),
    "k3-b2-lp1": (3, 2, False, False, False, None, 1.0, "kv"),
    "k5-b3": (5, 3, False, False, False, None, None, "mel"),
    "k3-b3-kvq": (3, 3, True, False, False, None, None, "kv"),
    "k5-b2-kvq-skvq-lp1": (5, 2, True, True, False, None, 1.0, "mel"),
    "k3-b2-timestamps": (3, 2, False, False, True, None, None, "kv"),
    "k3-b3-kvq-skvq-timestamps": (3, 3, True, True, True, None, None, "mel"),
    "k2-b3-prompt": (2, 3, False, False, False, (6, 3, 0), None, "kv"),
    "k5-b2-kvq-skvq-prompt-lp1": (5, 2, True, True, False, (4, 6), 1.0, "mel"),
    "k3-b2-kvq-timestamps-prompt": (3, 2, True, False, True, (0, 5), None, "kv"),
}


def _candidate_margin(model, cross, prompts, pads, got, want):
    """(row, position, port token, JAX token, log-prob of JAX's token minus
    the port's) at the first differing token, the logits teacher-forced on
    the shared prefix."""
    b, t = map(int, np.argwhere(got != want)[0])
    idx = torch.tensor([b])
    pad = None if pads is None else torch.from_numpy(pads[b:b + 1]).long()
    kv = tm.KVCache.create(PCFG, 1, device="cpu")
    logits, _ = tm.decoder_forward(model, torch.from_numpy(want[b:b + 1, :t]).long(), 0, kv,
                                   index_cross_kv(cross, idx), pad=pad)
    lp = torch.log_softmax(logits[0, -1], dim=-1)
    return b, t, int(got[b, t]), int(want[b, t]), float(lp[want[b, t]] - lp[got[b, t]])


def run_both(weights, mel, prompts, pads, sot_index, *, K, kvq=False, skvq=False,
             timestamps=False, length_penalty=None, entry="mel", max_tokens=MAX_TOKENS):
    """(port result, JAX result, port cross-KV) of one beam search on both."""
    jp, model = weights
    kw = dict(beam_size=K, max_tokens=max_tokens, timestamps=timestamps,
              length_penalty=length_penalty, sot_index=sot_index, self_kv_quant=skvq)
    jpad = None if pads is None else jnp.asarray(pads)
    tpad = None if pads is None else torch.from_numpy(pads).long()
    supp_t = torch.from_numpy(SUPPRESS).long()
    cross = encode_cross_kv(model, torch.from_numpy(mel), kv_quant=kvq)
    if entry == "mel":
        want = jax_beam_search(jp, jnp.asarray(mel), jnp.asarray(prompts), CFG, kv_quant=kvq,
                               suppress_ids=jnp.asarray(SUPPRESS), prompt_pad=jpad, **kw)
        got = beam_search(model, torch.from_numpy(mel), torch.from_numpy(prompts).long(),
                          kv_quant=kvq, suppress_ids=supp_t, prompt_pad=tpad, **kw)
    else:
        jkv = jax_encode_cross_kv(jp, jnp.asarray(mel), CFG, kv_quant=kvq)
        want = jax_beam_search_kv(jp, jkv, jnp.asarray(prompts), CFG,
                                  suppress_ids=jnp.asarray(SUPPRESS), prompt_pad=jpad, **kw)
        got = beam_search_kv(model, cross, torch.from_numpy(prompts).long(),
                             suppress_ids=supp_t, prompt_pad=tpad, **kw)
    return got, want, cross


def assert_equal_results(weights, cross, prompts, pads, got, want, kvq):
    for field in ("tokens", "all_tokens"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if not np.array_equal(a, b):
            flat = (lambda x: x.reshape(-1, x.shape[-1])) if a.ndim == 3 else (lambda x: x)
            k = a.shape[1] if a.ndim == 3 else 1
            rows = np.repeat(np.arange(a.shape[0]), k)
            r, t, pt, jt, margin = _candidate_margin(
                weights[1], cross, prompts[rows], None if pads is None else pads[rows],
                flat(a), flat(b))
            pytest.fail(f"{field}: first difference at row {r}, position {t} (port {pt}, "
                        f"JAX {jt}); candidate margin {margin:.3g} nats")
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    tol = dict(rtol=1e-4, atol=1e-5) if kvq else dict(rtol=0, atol=1e-5)
    for field in ("scores", "all_scores", "avg_logprob"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   **tol, err_msg=field)
    np.testing.assert_allclose(got.no_speech_prob.numpy(), np.asarray(want.no_speech_prob),
                               rtol=1e-4 if kvq else 0, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_beam_search_equals_jax(weights, case):
    K, b, kvq, skvq, ts, context, lp, entry = CASES[case]
    mel = _mel(7, b)
    prompts, pads, sot_index = _prompts(b, ts, context)
    got, want, cross = run_both(weights, mel, prompts, pads, sot_index, K=K, kvq=kvq, skvq=skvq,
                                timestamps=ts, length_penalty=lp, entry=entry)
    assert isinstance(got, BeamResult) and got.all_tokens.shape == (b, K, CFG.n_text_ctx)
    # one flag read a round of ROUND_STEPS steps, whole rounds on the device
    assert got.steps > 0 and got.host_syncs == max(1, -(-got.steps // ROUND_STEPS))
    assert got.device_steps == got.host_syncs * ROUND_STEPS
    assert_equal_results(weights, cross, prompts, pads, got, want, kvq)


def test_finished_set_and_fallback_both_run(weights):
    """The eot lean does what the module docstring says on the cases'
    inputs: one utterance of the batch finishes early, one runs to the cap
    with an empty finished set (the fallback)."""
    got, _, _ = run_both(weights, _mel(7, 3), *_prompts(3), K=5)
    fin = (got.all_scores > NEG_INF / 2).numpy()
    assert fin.all(axis=1).any() and (~fin).all(axis=1).any()
    P = len(CFG.sot_sequence("zh"))
    assert got.lengths.min() < P + MAX_TOKENS - 1 and got.lengths.max() == P + MAX_TOKENS


def test_limit_fills_the_cache_exactly(plain_weights):
    """No token budget: limit = n_text_ctx = 32 = the cache's 128-rounded
    size; the beams run to the cap, so the last step writes its key at
    position 30 of 32 (a write past the cache raises in the port)."""
    prompts, pads, sot_index = _prompts(2)
    for kvq in (False, True):
        got, want, cross = run_both(plain_weights, _mel(9, 2), prompts, pads, sot_index, K=3,
                                    kvq=kvq, skvq=kvq, max_tokens=None)
        assert_equal_results(plain_weights, cross, prompts, pads, got, want, kvq)
        assert got.steps == CFG.n_text_ctx - 1 - prompts.shape[1]
        assert (got.lengths == CFG.n_text_ctx).all()


@pytest.mark.parametrize("cross_kind", ["float", "int8"])
def test_decoder_forward_beam_k_equals_jax(weights, cross_kind):
    """One S=1 step of 2 utterances x 3 beams (each beam its own prefix)
    with ``beam_k=3`` against the unexpanded cross-KV, the same (JAX's)
    cross-KV on both sides: the JAX package's logits (1e-5) and the port's
    own step against the cross-KV tiled per beam."""
    jp, model = weights
    K, Bu = 3, 2
    N = K * Bu
    kvq = cross_kind == "int8"
    mel = _mel(5, Bu)
    jkv = jax_encode_cross_kv(jp, jnp.asarray(mel), CFG, kv_quant=kvq)
    tkv = tuple(torch.from_numpy(np.array(x)) for x in jkv)
    jtiled = tuple(jnp.repeat(x, K, axis=1) for x in jkv)
    ttiled = index_cross_kv(tkv, torch.arange(Bu).repeat_interleave(K))
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, 50000, (N, 4)).astype(np.int32)
    step = rng.integers(0, 50000, (N, 1)).astype(np.int32)
    jcache = jm.KVCache.create(CFG, N, ctx=32)
    tcache = tm.KVCache.create(PCFG, N, ctx=32, device="cpu")
    _, jcache = jm.decoder_forward(jp, jnp.asarray(prefix), 0, jcache, jtiled, CFG)
    _, tcache = tm.decoder_forward(model, torch.from_numpy(prefix).long(), 0, tcache, ttiled)
    tiled_cache = tm.KVCache(*(t.clone() for t in tcache))
    want, _ = jm.decoder_forward(jp, jnp.asarray(step), 4, jcache, jkv, CFG, beam_k=K)
    got, _ = tm.decoder_forward(model, torch.from_numpy(step).long(), 4, tcache, tkv, beam_k=K)
    tiled, _ = tm.decoder_forward(model, torch.from_numpy(step).long(), 4, tiled_cache, ttiled)
    assert got.shape == (N, 1, CFG.n_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    torch.testing.assert_close(got, tiled, rtol=0, atol=1e-5)


def test_fold_runs_no_cross_decode_kernel(weights, monkeypatch):
    """Under ``beam_k`` the int8 cross-attention is the folded plain
    product, as JAX's einsum: the S=1 decode kernel is never called."""
    _, model = weights
    calls = []
    real = tm.attention_int8kv
    monkeypatch.setattr(tm, "_cross_decode_kernel",
                        lambda kind: pytest.fail(f"{kind} kernel called under beam_k"))
    monkeypatch.setattr(tm, "attention_int8kv", lambda q, *a, **k: (calls.append(q.shape),
                                                                    real(q, *a, **k))[1])
    cross = encode_cross_kv(model, torch.from_numpy(_mel(5, 2)), kv_quant=True)
    cache = tm.QKVCache.create(PCFG, 6, ctx=32, device="cpu")
    tm.decoder_forward(model, torch.zeros((6, 1), dtype=torch.long), 0, cache, cross, beam_k=3)
    assert calls == [(2, PCFG.n_text_head, 3, PCFG.head_dim_text)] * PCFG.n_text_layer


@pytest.mark.parametrize("rows", ["ties", "neg_inf"])
def test_top_k_breaks_ties_as_jax(rows):
    """Rows full of ties (a handful of values, NEG_INF runs, the beam-0
    mask of the first expansion) pick the same indices as
    ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    if rows == "ties":
        x = rng.integers(0, 4, (6, 40)).astype(np.float32)
    else:
        x = np.full((6, 40), NEG_INF, np.float32)
        x[0, 7] = -3.0
        x[1, :10] = rng.standard_normal(10)
        x[2, 20:] = -1.0  # beam 0 masked out, the other beams tied
        x[3] = NEG_INF / rng.integers(1, 5, 40)  # dead eot candidates normalized
    for k in (1, 3, 10, 25):
        vals, idx = jax.lax.top_k(jnp.asarray(x), k)
        got_vals, got_idx = _top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(got_vals.numpy(), np.asarray(vals))


# ---------------------------------------------- tests/test_beam.py, on the port
# As there, the batch and beam-1 properties run on the unleaning random
# weights: on the eot-leaning ones candidate sums tie within fp32 noise, and
# a batched product's other summation order flips them (in the JAX package
# too: a row decoded alone there ends at another length than in its batch)
def _port(model, mel, K, timestamps=False, **kw):
    prompts, _, _ = _prompts(mel.shape[0], timestamps)
    return beam_search(model, torch.from_numpy(mel), torch.from_numpy(prompts).long(),
                       beam_size=K, timestamps=timestamps, **kw)


def test_beam1_equals_greedy(plain_weights):
    model = plain_weights[1]
    mel = _mel(11, 2)
    prompts, _, _ = _prompts(2)
    g = greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompts).long(),
                      max_tokens=MAX_TOKENS)
    b = _port(model, mel, 1, apply_filters=False, max_tokens=MAX_TOKENS)
    assert torch.equal(g.tokens, b.tokens) and torch.equal(g.lengths, b.lengths)


def test_batch_equals_rows_alone_and_repeats(plain_weights):
    model = plain_weights[1]
    mel = _mel(12, 3)
    both = _port(model, mel, 3, apply_filters=False, max_tokens=MAX_TOKENS)
    for r in range(3):
        alone = _port(model, mel[r:r + 1], 3, apply_filters=False, max_tokens=MAX_TOKENS)
        assert torch.equal(both.tokens[r], alone.tokens[0])
        assert torch.equal(both.all_tokens[r], alone.all_tokens[0])
    again = _port(model, mel, 3, apply_filters=False, max_tokens=MAX_TOKENS)
    assert torch.equal(both.tokens, again.tokens) and torch.equal(both.scores, again.scores)


def test_score_is_the_teacher_forced_logprob_and_prompt_kept(weights):
    """The winner's score is the mean log-prob of its tokens and eot under
    the model and the suppression rules, teacher-forced; its prompt is kept
    and the buffer is eot after it."""
    model = weights[1]
    mel = _mel(7, 3)  # the inputs of test_finished_set_and_fallback_both_run
    supp = torch.from_numpy(SUPPRESS).long()
    res = _port(model, mel, 3, suppress_ids=supp, max_tokens=MAX_TOKENS)
    P = 4
    cross = encode_cross_kv(model, torch.from_numpy(mel))
    scored = 0
    for b in range(3):
        length = int(res.lengths[b])
        toks = res.tokens[b]
        assert torch.equal(toks[:P], torch.as_tensor(CFG.sot_sequence("zh")))
        assert (toks[length:] == CFG.eot).all()
        if length >= P + MAX_TOKENS:
            continue  # ran to the cap: no eot to score
        seq = toks[: length + 1]
        kv = tm.KVCache.create(PCFG, 1, device="cpu")
        logits, _ = tm.decoder_forward(model, seq[None, :-1], 0, kv,
                                       index_cross_kv(cross, torch.tensor([b])))
        n = len(seq) - P
        # the rules of sampled token j (not timestamps): only their count matters
        rs = RuleState.create(n, device="cpu")._replace(n_sampled=torch.arange(n))
        lp = torch.log_softmax(apply_rules(logits[0, P - 1:], rs, PCFG, suppress_ids=supp), -1)
        picked = lp[torch.arange(n), seq[P:]]
        assert abs(float(res.scores[b]) - float(picked.mean())) < 1e-3
        scored += 1
    assert scored


def test_timestamp_grammar(weights):
    res = _port(weights[1], _mel(14, 2), 3, timestamps=True, max_tokens=10)
    ts0 = CFG.timestamp_begin
    for b in range(2):
        gen = [int(t) for t in res.tokens[b, 3: int(res.lengths[b])]]
        assert gen and ts0 <= gen[0] <= ts0 + 50
        stamps = [t for t in gen if t >= ts0]
        assert stamps == sorted(stamps)
    p = res.no_speech_prob.numpy()
    assert p.shape == (2,) and ((p >= 0) & (p <= 1)).all()
