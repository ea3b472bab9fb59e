"""A cell of the benchmark cut to ``tiny`` widths and a handful of clips,
for the CPU tests: the same harness, drivers, reference and judge."""

from __future__ import annotations

import contextlib
import io
import json
import os
import time

import torch

from portbench import harness, spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = dict(d_model=384, encoder_layers=4, decoder_layers=4, encoder_attention_heads=6,
            decoder_attention_heads=6, encoder_ffn_dim=1536, decoder_ffn_dim=1536,
            num_mel_bins=80, vocab_size=51865)
FP32 = dict(compute_dtype="float32", quantize=False, w8a8=False, kv_quant=False,
            self_kv_quant=False)
INT8 = dict(compute_dtype="float32", quantize=True, w8a8=True, kv_quant=True,
            self_kv_quant=True)
SMALL = {"offline": dict(batch=2, new_tokens=6, distinct_batches=1, warm_batches=1,
                         profile_batches=1, judge_requests=2),
         "serve": dict(rate_per_s=2.0, clip_seconds=[1.0, 4.0], max_tokens=12, warm_requests=2,
                       judge_requests=3, settle_seconds=120.0,
                       profile_seconds=[0.5, 1.0])}


def cell(workload: str, precision: dict = FP32) -> spec.Cell:
    c = spec.load_cell(ROOT, workload)
    c.config = {**c.config, **TINY, "name": "tiny",
                "precision": {**c.config["precision"], **precision}}
    kind = c.traffic["kind"]
    c.traffic = {**c.traffic, **SMALL[kind]}
    if kind == "serve":
        c.traffic["engine"] = {**c.traffic["engine"], "max_slots": 4, "steps_per_sync": 4,
                               "max_tokens": 12}
    return c


def run(workload: str, seed: int = 2 ** 31 + 12345, seconds: float = 1.0, trace: int = 0,
        precision: dict = FP32) -> dict:
    """One run of the tiny cell on the CPU: the result line as a dict, with
    the traced run's earlier line under ``"earlier"``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], root=ROOT, t0=time.perf_counter(),
                          device=torch.device("cpu"), cell=cell(workload, precision))
    assert rc == 0
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    result = lines[-1]
    if trace:
        result["earlier"] = lines[-2]["earlier"]
    return result
