"""The Uni-MoE-2.0-Omni cell cut to a tiny size that keeps its ratios (the
port's ``test-omni`` preset: test-nano's encoder, 7 query heads a KV head,
4 routed experts, a null one and 2 fixed ones an eighth of the routed
width, top-p 0.7 capped at 2, 2 layers, a vocabulary of 512) and a
handful of clips, for the CPU tests: the same harness, driver, reference
and judge."""

from __future__ import annotations

import contextlib
import io
import json
import time

import torch

from portbench import harness, spec
from portbench.tests.tiny import ROOT

CELL = "uni-moe-offline-b64"
TINY = dict(whisper_hidden_size=64, hidden_size=112, num_hidden_layers=2,
            num_attention_heads=7, num_key_value_heads=1, vocab_size=512,
            shared_intermediate_size=32, dynamic_intermediate_size=256,
            whisper_query_tokens_size=8)
TINY_ASSUMED = {"audio_encoder": {"num_mel_bins": 80, "encoder_layers": 2,
                                  "encoder_attention_heads": 2, "encoder_ffn_dim": 256,
                                  "max_source_positions": 96},
                "prompt": {"prefix_ids": 4, "suffix_ids": 4, "ids_below": 500, "stop_id": 511}}
# the tiny configuration's own limits, between its two readings on the CPU
# (W8A8, seeds 1-8 as tests/test_torch_omni.py serves them): the program's
# widest gap 0.0375 and log-probability error 0.0162, the int4 control's
# least 0.868 and 0.115
LIMITS = {"max_logit_gap": {"limit": 0.2}, "max_logprob_error": {"limit": 0.05}}
FP32 = dict(compute_dtype="float32", w8a8=False)
SMALL = dict(batch=2, new_tokens=10, distinct_batches=1, warm_batches=1, profile_batches=1,
             judge_requests=2)


def cell(precision: dict = FP32) -> spec.Cell:
    c = spec.load_cell(ROOT, CELL)
    c.config = {**c.config, **TINY, "name": "tiny-omni",
                "assumed": {**c.config["assumed"], **TINY_ASSUMED},
                "precision": {**c.config["precision"], **precision}}
    c.traffic = {**c.traffic, **SMALL}
    c.limits = LIMITS
    return c


def run(seed: int = 2 ** 31 + 12345, seconds: float = 0.5, trace: int = 0,
        precision: dict = FP32) -> dict:
    """One run of the tiny cell on the CPU: the result line as a dict, with
    the traced run's earlier line under ``"earlier"``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], root=ROOT, t0=time.perf_counter(),
                          device=torch.device("cpu"), cell=cell(precision))
    assert rc == 0
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    result = lines[-1]
    if trace:
        result["earlier"] = lines[-2]["earlier"]
    return result
