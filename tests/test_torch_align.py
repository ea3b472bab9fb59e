"""``whisper_tpu_torch.align`` and the tokenizer's word split against the JAX
package (CPU, test-nano, fp32, the same seeded inputs and bridged weights).

Exact: ``dequantize_cross_kv``, ``alignment_head_mask``, ``median_filter``,
``dtw_path``, ``merge_punctuations`` and ``split_to_word_tokens``. Within
rtol 1e-4 / atol 1e-5: ``alignment_cross_attn`` and ``alignment_matrix`` on
the rows and frames the host reads (rows outside the mask divide by a
near-zero deviation and are not compared). ``words_from_matrix`` on one
matrix and ``words_from_attention`` on one map stack: equal words and
times, probabilities within 1e-4.

Random weights decode one repeated token, so the word grouping is held on
teacher-forced real text: an English sentence with punctuation and a zh
one, through both packages' alignment passes and word grouping. Their words
must be equal; where a DTW near-tie flips the path, the test reports the
first divergent cell and its margin and holds the margin within what the
matrices' own difference can move (``_near_tie``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import whisper_tpu.align as ja
from whisper_tpu.config import get_config
from whisper_tpu.decode import encode_cross_kv as jax_encode_cross_kv
from whisper_tpu.models import model as jm
from whisper_tpu.tokenizer import get_tokenizer as jax_tokenizer
from whisper_tpu_torch import align as ta
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.decode import encode_cross_kv
from whisper_tpu_torch.models.model import Shards, shard_values
from whisper_tpu_torch.parallel.sharding import make_mesh, shard_params
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.tokenizer import get_tokenizer

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
RTOL, ATOL = 1e-4, 1e-5    # fp32 sums in another order than XLA's
PROB_TOL = 1e-4            # word probabilities from log-probs within RTOL
MESH_TOL = 1e-5            # the ranks' partial head sums, added on the lead device
EN_TEXT = " The quick brown fox, jumps over the lazy dog."
ZH_TEXT = "我们今天去公园散步，天气很好。"


@pytest.fixture(scope="module")
def weights():
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), PCFG, device="cpu")


def _cross(seed=11, B=2):
    r = np.random.default_rng(seed)
    shape = (CFG.n_text_layer, B, CFG.n_text_head, CFG.n_audio_ctx, CFG.head_dim_text)
    return tuple(r.standard_normal(shape).astype(np.float32) for _ in range(2))


def _both_cross(kind, seed=11, B=2):
    """(JAX float cross-KV, the port's), float or int8 through
    ``dequantize_cross_kv`` on each side."""
    fp = _cross(seed, B)
    if kind == "fp":
        return tuple(jnp.asarray(a) for a in fp), tuple(torch.from_numpy(a) for a in fp)
    q = jm.quantize_cross_kv(tuple(jnp.asarray(a) for a in fp))
    return (ja.dequantize_cross_kv(q),
            ta.dequantize_cross_kv(tuple(torch.from_numpy(np.array(a)) for a in q)))


def _case(seed=21, B=2, S=12):
    """Token rows, row mask and frame counts with ragged rows and frames."""
    rng = np.random.default_rng(seed)
    tokens = np.full((B, S), CFG.eot, np.int32)
    lengths, frames, prompt_len = [S, 8], [CFG.n_audio_ctx, 20], 2
    row_mask = np.zeros((B, S), bool)
    for b in range(B):
        tokens[b, :lengths[b]] = rng.integers(0, 200, lengths[b])
        row_mask[b, prompt_len:lengths[b]] = True
    return tokens, row_mask, np.asarray(frames, np.int32), prompt_len, lengths


# ------------------------------------------------------------ exact host side
def test_dequantize_cross_kv_equals_jax():
    fp = tuple(jnp.asarray(a) for a in _cross())
    q = jm.quantize_cross_kv(fp)
    want = ja.dequantize_cross_kv(q)
    got = ta.dequantize_cross_kv(tuple(torch.from_numpy(np.array(a)) for a in q))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fp_t = tuple(torch.from_numpy(np.array(a)) for a in fp)
    assert ta.dequantize_cross_kv(fp_t) is fp_t
    halves = Shards([tuple(torch.from_numpy(np.array(a)[:, :, h:h + 1]) for a in q)
                     for h in range(2)])
    for h, part in enumerate(ta.dequantize_cross_kv(halves)):
        np.testing.assert_array_equal(part[0].numpy(), np.asarray(want[0])[:, :, h:h + 1])


@pytest.mark.parametrize("source", ["default", "argument", "environment", "bare list"])
def test_alignment_head_mask_equals_jax(source, tmp_path, monkeypatch):
    path = tmp_path / "heads.json"
    pairs = [[0, 1], [1, 0]]
    path.write_text(json.dumps(pairs if source == "bare list" else {"test-nano": pairs}))
    sidecar = None if source in ("default", "environment") else str(path)
    if source == "environment":
        monkeypatch.setenv("WHISPER_TPU_ALIGNMENT_HEADS", str(path))
    got = ta.alignment_head_mask(PCFG, sidecar)
    np.testing.assert_array_equal(got, ja.alignment_head_mask(CFG, sidecar))
    assert got.sum() == (2 if source != "default" else CFG.n_text_head)


@pytest.mark.parametrize("width", [1, 3, 5, 7])
def test_median_filter_equals_jax(width):
    x = np.random.default_rng(width).standard_normal((3, 2, 33)).astype(np.float32)
    np.testing.assert_array_equal(ta.median_filter(x, width), ja.median_filter(x, width))


def test_dtw_path_equals_jax():
    """Random costs, a matrix of ties (the move order decides) and one row
    or one column."""
    rng = np.random.default_rng(7)
    costs = [rng.random((13, 29)), rng.random((29, 13)), np.zeros((6, 9)),
             np.round(rng.random((8, 20)), 1), rng.random((1, 7)), rng.random((7, 1))]
    for cost in costs:
        got, want = ta.dtw_path(cost), ja.dtw_path(cost)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_merge_punctuations_equals_jax():
    words = [{"word": w, "start": float(i), "end": i + 0.5}
             for i, w in enumerate([" \"", "hi", ",", " there", " (", "you", ")", "!", " ¿",
                                    "que", "?", " 。"])]
    assert ta.merge_punctuations(words) == ja.merge_punctuations(words)
    assert ta.merge_punctuations([]) == ja.merge_punctuations([]) == []


@pytest.mark.parametrize("language,text", [("en", EN_TEXT), ("zh", ZH_TEXT),
                                           ("ja", "今日は、いい天気ですね。")])
def test_split_to_word_tokens_equals_jax(language, text):
    tok = get_tokenizer(language=language, task="transcribe")
    jtok = jax_tokenizer(True, language=language, task="transcribe")
    ids = tok.encode(text) + [tok.timestamp_begin + 50, tok.eot]
    assert ids[:-2] == jtok.encode(text)
    assert tok.split_to_word_tokens(ids) == jtok.split_to_word_tokens(ids)
    words, groups = tok.split_to_word_tokens(ids)
    assert "".join(words[:-2]) == text and sum(map(len, groups)) == len(ids)


# ------------------------------------------------------------ device pass
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_alignment_cross_attn_equals_jax(weights, kind):
    jp, model = weights
    jcross, tcross = _both_cross(kind)
    tokens = _case()[0]
    want, want_lp = ja.alignment_cross_attn(jp, jnp.asarray(tokens), jcross, CFG)
    got, got_lp = ta.alignment_cross_attn(model, torch.from_numpy(tokens).long(), tcross)
    assert got.shape == (CFG.n_text_layer, 2, CFG.n_text_head, 12, CFG.n_audio_ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=RTOL, atol=ATOL)


def _matrices(weights, jcross, tcross, tokens, row_mask, frames, width=7, model=None):
    jp, port = weights
    hm = ja.alignment_head_mask(CFG)
    want, want_lp = ja.alignment_matrix(jp, jnp.asarray(tokens), jcross, jnp.asarray(hm, jnp.float32),
                                        jnp.asarray(row_mask), jnp.asarray(frames), CFG,
                                        medfilt_width=width)
    got, got_lp = ta.alignment_matrix(model or port, torch.from_numpy(tokens).long(), tcross,
                                      torch.from_numpy(hm.astype(np.float32)),
                                      torch.from_numpy(row_mask), torch.from_numpy(frames),
                                      medfilt_width=width)
    return (np.asarray(want), np.asarray(want_lp)), (got.numpy(), got_lp.numpy())


@pytest.mark.parametrize("width", [7, 5])
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_alignment_matrix_equals_jax(weights, kind, width):
    """On each row's text rows and audio frames (what the host reads)."""
    tokens, row_mask, frames, pl, lengths = _case()
    jcross, tcross = _both_cross(kind)
    (want, want_lp), (got, got_lp) = _matrices(weights, jcross, tcross, tokens, row_mask, frames,
                                               width)
    assert got.shape == (2, 12, CFG.n_audio_ctx)
    for b in range(2):
        np.testing.assert_allclose(got[b, pl:lengths[b], :frames[b]],
                                   want[b, pl:lengths[b], :frames[b]], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lp, want_lp, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="odd"):
        ta.alignment_matrix(weights[1], torch.from_numpy(tokens).long(), tcross,
                            torch.ones(2, 2), torch.from_numpy(row_mask),
                            torch.from_numpy(frames), medfilt_width=4)


def test_median_taps_equal_numpy():
    rng = np.random.default_rng(9)
    for w in (1, 3, 5, 7, 9):
        arrs = [rng.standard_normal((3, 17)).astype(np.float32) for _ in range(w)]
        got = ta._median_taps([torch.from_numpy(a) for a in arrs]).numpy()
        np.testing.assert_array_equal(got, np.median(np.stack(arrs), axis=0))


def test_alignment_matrix_on_a_cpu_mesh_equals_one_rank(weights):
    """A (1, 2) mesh of CPU ranks (one head each) sums the ranks' masked
    head sums on the lead device: within MESH_TOL of the one-rank pass."""
    tokens, row_mask, frames, pl, lengths = _case()
    _, tcross = _both_cross("fp")
    sharded = shard_params(from_jax_params(jax.tree.map(np.asarray, weights[0]), PCFG,
                                           device="cpu"), make_mesh(1, 2, devices=["cpu"] * 2))
    per_rank = Shards([tuple(t[:, :, h:h + 1] for t in tcross) for h in range(2)])
    hm = torch.from_numpy(ja.alignment_head_mask(CFG).astype(np.float32))
    args = (torch.from_numpy(row_mask), torch.from_numpy(frames))
    one, one_lp = ta.alignment_matrix(weights[1], torch.from_numpy(tokens).long(), tcross, hm,
                                      *args)
    two, two_lp = ta.alignment_matrix(sharded, torch.from_numpy(tokens).long(), per_rank, hm,
                                      *args)
    for b in range(2):
        np.testing.assert_allclose(two[b, pl:lengths[b], :frames[b]].numpy(),
                                   one[b, pl:lengths[b], :frames[b]].numpy(), rtol=0,
                                   atol=MESH_TOL)
    np.testing.assert_allclose(two_lp.numpy(), one_lp.numpy(), rtol=0, atol=MESH_TOL)
    attn, _ = ta.alignment_cross_attn(sharded, torch.from_numpy(tokens).long(), per_rank)
    ref, _ = ta.alignment_cross_attn(weights[1], torch.from_numpy(tokens).long(), tcross)
    np.testing.assert_allclose(attn.numpy(), ref.numpy(), rtol=0, atol=MESH_TOL)
    assert len(shard_values(per_rank)) == 2


# ------------------------------------------------------------ words
def test_words_from_matrix_on_the_jax_matrix(weights):
    """The same (JAX) matrix and log-probs through both word groupings."""
    tok = get_tokenizer(language="en", task="transcribe")
    jtok = jax_tokenizer(True, language="en", task="transcribe")
    seq = list(CFG.sot_sequence("en")) + tok.encode(EN_TEXT) + [CFG.eot]
    tokens = np.full((1, 32), CFG.eot, np.int32)
    tokens[0, :len(seq)] = seq
    row_mask = np.zeros((1, 32), bool)
    pl = len(CFG.sot_sequence("en"))
    row_mask[0, pl:len(seq)] = True
    jcross, _ = _both_cross("fp", B=1)
    hm = ja.alignment_head_mask(CFG)
    matrix, tlp = ja.alignment_matrix(weights[0], jnp.asarray(tokens), jcross,
                                      jnp.asarray(hm, jnp.float32), jnp.asarray(row_mask),
                                      jnp.asarray([CFG.n_audio_ctx]), CFG)
    m, lp = np.asarray(matrix)[0, pl:len(seq)], np.asarray(tlp)[0]
    want = ja.words_from_matrix(m, seq[pl:], jtok, token_logprobs=lp, prompt_len=pl)
    got = ta.words_from_matrix(m, seq[pl:], tok, token_logprobs=lp, prompt_len=pl)
    _same_words(got, want)
    # the comma and the full stop stand alone until merge_punctuations
    assert len(got) == 11 and len(ta.merge_punctuations(got)) == 9
    assert ta.words_from_matrix(m[:0], [], tok) == []


@pytest.mark.parametrize("language,text", [("en", EN_TEXT), ("zh", ZH_TEXT)])
def test_words_from_attention_equals_jax(weights, language, text):
    """The host path from the full maps (JAX's alignment_cross_attn of a
    teacher-forced real sentence): standardization, median filter, head
    mean, DTW and word split on the host, both packages."""
    tok = get_tokenizer(language=language, task="transcribe")
    jtok = jax_tokenizer(True, language=language, task="transcribe")
    prompt = list(CFG.sot_sequence(language))
    seq = prompt + tok.encode(text) + [CFG.eot]
    jcross, _ = _both_cross("fp", B=1)
    attn, tlp = ja.alignment_cross_attn(weights[0], jnp.asarray([seq], jnp.int32), jcross, CFG)
    attn, tlp = np.asarray(attn)[:, 0], np.asarray(tlp)[0]
    kw = dict(token_logprobs=tlp, medfilt_width=7)
    want = ja.words_from_attention(attn, seq, len(prompt), jtok, CFG, 80, **kw)
    got = ta.words_from_attention(attn, seq, len(prompt), tok, PCFG, 80, **kw)
    _same_words(got, want)
    assert "".join(w["word"] for w in got).strip() == text.strip()


def _same_words(got, want):
    assert [(w["word"], w["start"], w["end"]) for w in got] == \
        [(w["word"], w["start"], w["end"]) for w in want]
    np.testing.assert_allclose([w["probability"] for w in got],
                               [w["probability"] for w in want], rtol=0, atol=PROB_TOL)


def _dtw_costs(cost: np.ndarray) -> np.ndarray:
    """The accumulated cost D of ``dtw_path`` (float64, (N+1, M+1))."""
    N, M = cost.shape
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, N + 1):
        for j in range(1, M + 1):
            D[i, j] = cost[i - 1, j - 1] + min(D[i - 1, j - 1], D[i - 1, j], D[i, j - 1])
    return D


def _near_tie(m_port: np.ndarray, m_jax: np.ndarray) -> dict:
    """Where the two DTW paths part: the first divergent cell and the margin
    between the port's best and second-best moves into it. The paths may
    part only where that margin is within the accumulated difference of the
    two matrices along the path (``ok``)."""
    a, b = ta.dtw_path(-m_port.astype(np.float64)), ta.dtw_path(-m_jax.astype(np.float64))
    n = next((k for k in range(min(len(a[0]), len(b[0])))
              if (a[0][k], a[1][k]) != (b[0][k], b[1][k])), None)
    if n is None:
        return {"ok": False, "cell": None}
    i, j = int(a[0][n - 1]) + 1, int(a[1][n - 1]) + 1
    D = _dtw_costs(-m_port.astype(np.float64))
    moves = sorted([D[i, j], D[i - 1, j + 1] if j + 1 < D.shape[1] else np.inf,
                    D[i + 1, j] if i + 1 < D.shape[0] else np.inf])
    margin = float(moves[1] - moves[0])
    drift = float(np.abs(m_port - m_jax).sum())
    return {"ok": margin <= drift, "cell": (i, j), "margin": margin, "drift": drift}


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("language,text", [("en", EN_TEXT), ("zh", ZH_TEXT)])
def test_teacher_forced_words_equal_jax(weights, language, text, kv_quant):
    """Real text teacher-forced over the encoder's cross-KV of a seeded
    clip (float or int8): both packages' alignment pass, DTW, word split and
    (en) punctuation merge give the same words."""
    jp, model = weights
    tok = get_tokenizer(language=language, task="transcribe")
    jtok = jax_tokenizer(True, language=language, task="transcribe")
    prompt = list(CFG.sot_sequence(language))
    seq = prompt + tok.encode(text) + [CFG.eot]
    S, pl = 32, len(prompt)
    tokens = np.full((1, S), CFG.eot, np.int32)
    tokens[0, :len(seq)] = seq
    row_mask = np.zeros((1, S), bool)
    row_mask[0, pl:len(seq)] = True
    frames = np.asarray([CFG.n_audio_ctx], np.int32)
    mel = np.random.default_rng(31).standard_normal(
        (1, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    jcross = ja.dequantize_cross_kv(jax_encode_cross_kv(jp, jnp.asarray(mel), CFG, jnp.float32,
                                                        kv_quant=kv_quant))
    tcross = ta.dequantize_cross_kv(encode_cross_kv(model, torch.from_numpy(mel),
                                                    kv_quant=kv_quant))
    (want_m, want_lp), (got_m, got_lp) = _matrices(weights, jcross, tcross, tokens, row_mask,
                                                   frames)
    np.testing.assert_allclose(got_m[0, pl:len(seq)], want_m[0, pl:len(seq)], rtol=RTOL,
                               atol=ATOL)
    want = ja.words_from_matrix(want_m[0, pl:len(seq)], seq[pl:], jtok,
                                token_logprobs=want_lp[0], prompt_len=pl)
    if language == "en":
        want = ja.merge_punctuations(want)
    # a tokenizer of another language: row_words splits in the row's own
    other = get_tokenizer(language="zh" if language == "en" else "en")
    got = ta.row_words(got_m[0], got_lp[0], tokens[0], pl, len(seq), CFG.n_audio_ctx, language,
                       other)
    if [(w["word"], w["start"], w["end"]) for w in got] != \
            [(w["word"], w["start"], w["end"]) for w in want]:
        report = _near_tie(got_m[0, pl:len(seq) - 1], want_m[0, pl:len(seq) - 1])
        assert report["ok"], report
        return
    _same_words(got, want)
    assert "".join(w["word"] for w in got).strip() == text.strip()
    if language == "en":  # the comma and the full stop merged into their words
        assert [w["word"] for w in got][3:4] == [" fox,"] and got[-1]["word"] == " dog."
    starts = [w["start"] for w in got]
    assert starts == sorted(starts) and all(w["start"] <= w["end"] for w in got)
