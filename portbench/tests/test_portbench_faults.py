"""A run with the timed path broken underneath reads ``correct`` false, and
the control (the reference in int4 where the configuration serves int8)
reads wider gaps than the program: the check fails what it should."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench.tests import tiny


def _alter_first_token(result):
    """A GreedyResult with row 0's first generated token moved by one."""
    toks = result.tokens.clone()
    toks[0, 4] = (toks[0, 4] + 1) % 50257
    return result._replace(tokens=toks) if hasattr(result, "_replace") else \
        type(result)(**{**result.__dict__, "tokens": toks})


def test_offline_token_altered_where_produced(monkeypatch):
    import whisper_tpu_torch.pipeline as pipeline

    real = pipeline.greedy_decode_kv
    monkeypatch.setattr(pipeline, "greedy_decode_kv",
                        lambda *a, **k: _alter_first_token(real(*a, **k)))
    result = tiny.run("turbo-offline-b64")
    assert not result["correct"]
    assert result["checks"]["max_logit_gap"]["value"] > result["checks"]["max_logit_gap"]["limit"] \
        or result["checks"]["max_logit_gap"]["value"] > 0.1


def test_serving_token_altered_where_produced(monkeypatch):
    from whisper_tpu_torch.serving.engine import ContinuousBatchingEngine

    real = ContinuousBatchingEngine._harvest_host

    def altered(self, done_h, active_h, offs_h, tokens_h, *rest, **kw):
        tokens_h = np.array(tokens_h)
        for i in range(len(offs_h)):
            if self._slot_req[i] is not None and done_h[i]:
                at = self._slot_prompt_len[i]
                tokens_h[i, at] = (tokens_h[i, at] + 1) % 50257
        return real(self, done_h, active_h, offs_h, tokens_h, *rest, **kw)

    monkeypatch.setattr(ContinuousBatchingEngine, "_harvest_host", altered)
    result = tiny.run("turbo-serve-poisson")
    assert not result["correct"]


def test_unbroken_traced_run_is_correct_and_reads_its_metrics():
    result = tiny.run("turbo-offline-b64", trace=1, precision=tiny.INT8)
    assert result["correct"]
    assert "host.prep_ms" in result["metrics"] and "mfu.offline" in result["metrics"]
    assert set(result["device"]) >= {"busy_s", "window_s", "memory_peak_bytes"}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes(seed):
    """The control in the program's place, judged by the harness's own
    checks and ``correct`` against the cell's limits, is not correct on
    every seed, while the program is."""
    cell = tiny.cell("turbo-offline-b64", tiny.INT8)
    cell.traffic.update(batch=8, new_tokens=24, judge_requests=8, warm_batches=1)
    (row,) = control.readings(cell, [seed], 0.5, torch.device("cpu"), tiny.ROOT)
    assert row["tokens"] == 192
    assert row["program_correct"], row["program_checks"]
    assert not row["control_correct"], row["control_checks"]
    assert row["fault"] > 3 * row["program"]
