"""The Uni-MoE-2.0-Omni cell through the harness on the CPU, cut to a tiny
size that keeps its ratios (``omni_tiny``): ``correct`` holds for the
program in fp32 and in W8A8, fails with one served id moved, and a traced
run reads the routing counts and the per-layer metrics that need no card."""

import numpy as np
import pytest

from portbench.tests import omni_tiny

W8A8 = dict(compute_dtype="float32", w8a8=True)


def test_the_omni_cell_is_correct_in_fp32_and_w8a8():
    for precision in (omni_tiny.FP32, W8A8):
        r = omni_tiny.run(precision=precision)
        assert r["correct"] and r["judge"]["tokens"] > 0, r
        assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_one_served_id_moved_is_not_correct(monkeypatch):
    from whisper_tpu_torch.omni import OmniPipeline

    real = OmniPipeline.transcribe_batch

    def moved(self, audios):
        out = real(self, audios)
        out[0].tokens = np.concatenate([[(out[0].tokens[0] + 1) % self.cfg.n_vocab],
                                        out[0].tokens[1:]])
        return out

    monkeypatch.setattr(OmniPipeline, "transcribe_batch", moved)
    r = omni_tiny.run(precision=W8A8)
    assert not r["correct"], r
    gap = r["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_a_traced_run_reads_the_routing_counts():
    r = omni_tiny.run(trace=1, precision=W8A8)
    stats = r["earlier"]["moe_stats"]
    for phase in ("prefill", "decode"):
        s = stats[phase]
        assert s["decisions"] > 0 and 0 < s["one_expert_share"] < 1 and 0 < s["null_share"] < 1
    assert "host.prep_ms" in r["metrics"] and "mfu.omni" in r["metrics"]


def test_the_k8_roofline_reads_the_language_models_launches_alone():
    """``omni.k8_roofline`` times the K8 launches inside the prefill's and
    the decode's device spans (not the encoder's), and reads nothing where
    their number is not the one the shapes give."""
    from portbench import spec
    from portbench.harness import Run
    from portbench.omni_roofline import lm_k8_seconds
    from portbench.tracing import Trace

    d = omni_tiny.cell().family.dims(omni_tiny.cell().config)
    prefill = {"routed_tokens": [30, 20, 10, 4], "active_experts": 7}  # one expert unchosen
    least, n = lm_k8_seconds(d, 2, 1, 8, prefill)
    assert n == (4 * d.n_layer + 1) + 2 * 7 + 8 * (d.n_layer * (4 + 2 * d.n_routed) + 1)
    k8 = "void int8_gemm_sm90<1>(...)"
    encoder = [(k8, 0.0, 5.0)] * 3  # before the spans, as the encoder's launches are
    lm = [(k8, 100.0 + i, 101.0 + i) for i in range(n)]  # 1 us each
    facts = {"generated": [9, 9], "batch": 2, "decode_steps": 8,
             "moe": {"prefill": prefill}}

    def run(ops):
        trace = Trace(window_s=1.0, ops=ops, device={"whisper.omni.prefill": [(100.0, 110.0)],
                                                     "whisper.decode": [(110.0, 100.0 + n)]})
        return Run(dims=d, traffic={}, trace=trace, facts=facts)

    read = spec.reader("omni.k8_roofline")
    assert read(run(encoder + lm)) == pytest.approx(100.0 * least * 1e6 / n)
    assert read(run(encoder + lm[1:])) is None
