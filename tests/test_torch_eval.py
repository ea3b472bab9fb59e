"""The port's evaluation package against the JAX package's
(``whisper_tpu/eval``), test-nano on the CPU: the quantization gate variant
by variant, its thresholds, the WER arithmetic and datasets, and the WER
entry point end to end over a synthetic AIShell-format set."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.eval import quant_gate as jg
from whisper_tpu.eval import wer as jw
from whisper_tpu.models import model as jm
from whisper_tpu.pipeline import WhisperPipeline as JaxPipeline
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.eval import quant_gate as tg
from whisper_tpu_torch.eval import wer as tw
from whisper_tpu_torch.eval.__main__ import main as eval_main
from whisper_tpu_torch.params import from_jax_params
from whisper_tpu_torch.pipeline import WhisperPipeline

torch.set_num_threads(2)

CFG = get_config("test-nano")
PCFG = port_config("test-nano")
GATE_TOKENS = 8
# KL of the port's variant against JAX's, in nats per step. Every variant but
# w8a8 computes the same fp32 function on both sides (int8 payloads and
# scales are bit-equal), so only summation order separates them. W8A8 rounds
# activations to int8 per row: a value within fp32 round-off of a .5 tie
# rounds the other way on one side, and the step cascades through the
# encoder (ROADMAP fault 3.1: up to 3e-2 in the encoder's output on
# test-nano), which moves the KL by more.
KL_TOL = {"w8a8": 2e-5}
KL_TOL_DEFAULT = 1e-6


@pytest.fixture(scope="module")
def gate_inputs():
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    mel = (np.random.default_rng(0).standard_normal((2, CFG.n_mels, 2 * CFG.n_audio_ctx))
           * 0.3).astype(np.float32)
    return params, from_jax_params(jax.tree.map(np.asarray, params), PCFG, device="cpu"), mel


@pytest.mark.parametrize("variant", tg.VARIANTS)
def test_gate_variant_equals_jax(gate_inputs, variant):
    """Each variant on the same weights and mel: the port's top-1 agreement
    and step count equal JAX's ``run_gate``, its KL within ``KL_TOL``; the
    fp32 control reads zero (KL < 1e-6, top-1 1.0, no logit error)."""
    params, model, mel = gate_inputs
    want = jg.run_gate(params, CFG, jnp.asarray(mel), variant, max_tokens=GATE_TOKENS)
    got = tg.run_gate(model, torch.from_numpy(mel), variant, max_tokens=GATE_TOKENS)
    assert got.steps == want.steps > 0
    assert got.top1_agreement == want.top1_agreement
    assert abs(got.kl_mean - want.kl_mean) <= KL_TOL.get(variant, KL_TOL_DEFAULT)
    assert math.isfinite(got.logit_max_abs_err)
    if variant == "fp32":
        assert got.kl_mean < 1e-6 and got.top1_agreement == 1.0
        assert got.logit_max_abs_err == 0.0
    else:
        assert got.logit_max_abs_err > 0.0  # a different function
    assert got.row() == {**want.row(), "kl_mean_nats": got.row()["kl_mean_nats"],
                         "logit_max_abs_err": got.row()["logit_max_abs_err"]}


def test_gate_leaves_the_model_as_it_was(gate_inputs):
    """The quantized variants work on a copy: the caller's weights stay
    fp32, so the control after them still reads zero."""
    _, model, mel = gate_inputs
    tg.run_gate(model, torch.from_numpy(mel), "int8_all", max_tokens=4)
    assert model.encoder.blocks[0].attn["wq"].dtype == torch.float32
    assert tg.run_gate(model, torch.from_numpy(mel), "fp32", max_tokens=4).kl_mean == 0.0
    with pytest.raises(ValueError, match="unknown variant"):
        tg.run_gate(model, torch.from_numpy(mel), "int4")


def test_gate_thresholds_equal_jax():
    """``gate()`` passes and fails where JAX's does, at and past both
    thresholds, NaN included."""
    cases = [(0.0, 1.0), (0.02, 0.98), (0.0201, 1.0), (0.0, 0.9799), (float("nan"), 1.0),
             (0.5, 0.5)]
    for kl, top1 in cases:
        for extra in ([], [(0.0, 1.0)]):
            rows = [(kl, top1)] + extra
            t = {f"v{i}": tg.GateResult(f"v{i}", k, a, 0.0, 1) for i, (k, a) in enumerate(rows)}
            j = {f"v{i}": jg.GateResult(f"v{i}", k, a, 0.0, 1) for i, (k, a) in enumerate(rows)}
            assert tg.gate(t) == jg.gate(j), rows
            assert tg.gate(t, 0.6, 0.4) == jg.gate(j, 0.6, 0.4), rows
    r = tg.GateResult("x", 1.23456789, 0.987654, 0.123456, 7)
    assert r.row() == jg.GateResult(**dataclasses.asdict(r)).row()


def test_gate_main_on_the_cpu(capsys):
    """``python -m whisper_tpu_torch.eval.quant_gate --device cpu``: one JSON
    line with a row per variant, the random-init caveat, and the exit code
    that ``gate`` decides."""
    import json

    rc = tg.main(["--model", "test-nano", "--batch", "2", "--max_tokens", "4",
                  "--device", "cpu", "--variants", "fp32,int8_cross_kv"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["weights"] == "random-init" and "caveat" in out
    assert out["fp32"]["kl_mean_nats"] == 0.0 and out["fp32"]["top1_agreement"] == 1.0
    assert rc == (0 if out["pass"] else 1)


EDIT_CASES = [("", ""), ("abc", "abc"), ("abc", ""), ("", "abc"), ("kitten", "sitting"),
              ("今天天气", "今天天汽"), ("abc", "acb"), ("flaw", "lawn")]


@pytest.mark.parametrize("ref,hyp", EDIT_CASES)
def test_edit_distance_equals_jax(ref, hyp):
    assert tw.edit_distance(ref, hyp) == jw.edit_distance(ref, hyp)


@pytest.mark.parametrize("level", ["char", "word"])
def test_score_pairs_equals_jax(level):
    """The pairs of ``tests/test_wer.py`` (punctuation, accumulation, word
    level): the same totals and per-utterance rates."""
    pairs = [("a.wav", "今天天气不错。", "今天天气不错"), ("b.wav", "你好世界", "你好地球"),
             ("c.wav", "the quick brown fox", "the quick brown box"),
             ("d.wav", "Hello, World!", "hello world"), ("e.wav", "", "extra")]
    got, want = tw.score_pairs(pairs, level), jw.score_pairs(pairs, level)
    assert (got.total_errors, got.total_chars, got.per_utt) == \
        (want.total_errors, want.total_chars, want.per_utt)
    assert got.wer == want.wer


def test_datasets_equal_jax(tmp_path):
    gt = tmp_path / "ground_truth.txt"
    gt.write_text("BAC009S0764W0121 甚至出现交易几乎停止的情况\nbad\n"
                  "BAC009S0764W0122.wav 一二三\n", encoding="utf-8")
    tsv = tmp_path / "test.tsv"
    tsv.write_text("client_id\tpath\tsentence\nc1\ta.mp3\tHello there\nshort\n"
                   "c2\tb.mp3\tHi\n", encoding="utf-8")
    for ours, theirs in ((tw.AIShellDataset(str(gt)), jw.AIShellDataset(str(gt))),
                         (tw.CommonVoiceDataset(str(tsv)), jw.CommonVoiceDataset(str(tsv)))):
        assert len(ours) == len(theirs) == 2
        assert [(u.path, u.transcript) for u in ours] == [(u.path, u.transcript) for u in theirs]
    bad = tmp_path / "bad.tsv"
    bad.write_text("a\tb\n", encoding="utf-8")
    with pytest.raises(ValueError):
        tw.CommonVoiceDataset(str(bad))


def _aishell(tmp_path, n=5, seed=0):
    """A synthetic AIShell-format set: ``n`` seeded noise WAVs and their
    ground-truth lines."""
    from whisper_tpu.ops.audio import write_wav

    wav_dir = tmp_path / "aishell_S0764"
    wav_dir.mkdir()
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        write_wav(str(wav_dir / f"BAC0000{i}.wav"),
                  (rng.standard_normal(8000 * (i + 1)) * 0.05).astype(np.float32))
        lines.append(f"BAC0000{i} 测试句子{i}")
    gt = tmp_path / "ground_truth.txt"
    gt.write_text("\n".join(lines), encoding="utf-8")
    return gt


def test_evaluate_equals_jax(tmp_path):
    """``evaluate`` over the port's pipeline and JAX's ``evaluate`` over the
    JAX pipeline, the same weights (fp32): equal hypotheses and WER."""
    gt = _aishell(tmp_path)
    kw = dict(compute_dtype="float32", max_tokens=4, language="zh")
    jpipe = JaxPipeline(model="test-nano", **kw)
    pipe = WhisperPipeline(device="cpu", params=from_jax_params(
        jax.tree.map(np.asarray, jpipe.params), PCFG, device="cpu"), **kw)
    want = jw.evaluate(jpipe, jw.AIShellDataset(str(gt)), batch_size=2, limit=5)
    got = tw.evaluate(pipe, tw.AIShellDataset(str(gt)), batch_size=2, limit=5)
    assert got.per_utt == want.per_utt and got.wer == want.wer


@pytest.mark.parametrize("language", ["zh", "auto"])
def test_eval_main_end_to_end(tmp_path, language):
    """``python -m whisper_tpu_torch.eval`` over a synthetic AIShell-format
    set to a wer.txt, on the CPU, with a language and with ``auto`` (the WER
    of random weights means nothing; the plumbing is the test)."""
    gt = _aishell(tmp_path)
    log, out = tmp_path / "test_wer.log", tmp_path / "wer.txt"
    rc = eval_main(["--dataset", "aishell", "--gt_path", str(gt), "--model_type", "test-nano",
                    "--language", language, "--batch", "4", "--dtype", "float32",
                    "--limit", "5", "--device", "cpu",
                    "--log", str(log), "--out", str(out)])
    assert rc == 0
    wer = float(out.read_text().strip())
    assert math.isfinite(wer) and wer >= 0.0
    logged = log.read_text(encoding="utf-8")
    assert "Total WER" in logged and "BAC00000" in logged and logged.count("predict:") == 5
