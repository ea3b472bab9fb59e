"""The port's weights day (``python -m whisper_tpu_torch.weights_day``):
the dry run end to end on the CPU (marked slow, as the JAX script's test
is), held to what ``tests/test_weights_day.py`` holds of the JAX script's
report, and its step 0 and report writer alone. Nothing is downloaded:
step 0 only checks what is present."""

import argparse
import json
import os
import subprocess
import sys

import pytest

from whisper_tpu_torch import weights_day

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow  # ~20 s alone, over 90 s beside the whole suite under xdist
def test_weights_day_dry_run_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.weights_day", "--dry-run", "--device", "cpu",
         "--serving_dp", "1", "--workdir", str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    report = json.loads((tmp_path / "weights_day_report.json").read_text())
    assert report["dry_run"] is True and report["device"] == "cpu"
    assert report["fetch"].startswith("skipped")
    assert "golden" in report and "expected" in report["golden"]
    assert report["quant_gate"]["rc"] in (0, 1)  # random weights may trip the gate
    assert "wer" in report and report["wer"]
    for r in report["wer"].values():
        assert r["wer"] >= 0.0 and r["pass"] is None
    assert "silence_gate" in report and report["longform"]["audio_seconds"] > 30
    assert set(report["merge_sweep"]["merged"]) == {"0.6", "0.72", "0.85"}
    assert report["serving_golden"]["success"] is True
    assert isinstance(report["serving_spots"], list) and len(report["serving_spots"]) == 2
    md = (tmp_path / "weights_day_report.md").read_text()
    assert "DRY-RUN" in md and "| model |" in md
    assert any(p.name.startswith("wer_") for p in tmp_path.iterdir())


def _args(tmp_path, **kw):
    base = dict(dry_run=False, demo_wav=str(tmp_path / "demo.wav"),
                gt_path=str(tmp_path / "ground_truth.txt"), workdir=str(tmp_path),
                device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_step0_checks_assets_and_names_what_is_missing(tmp_path):
    """A real run stops at step 0 and names each missing asset; once the
    synthetic set and clip are in place it passes; a dry run skips it."""
    args = _args(tmp_path)
    with pytest.raises(SystemExit) as e:
        weights_day.step0_assets(args, {})
    msg = str(e.value)
    assert "demo clip" in msg and "ground truth" in msg and "dataset WAVs" in msg
    assert "vocab" not in msg  # the repository holds the vocab
    weights_day._synthetic_dataset(str(tmp_path))
    weights_day._synthetic_demo(str(tmp_path))
    report = {}
    weights_day.step0_assets(args, report)
    assert report["fetch"] == "ok (present)"
    weights_day.step0_assets(_args(tmp_path, dry_run=True), report)
    assert report["fetch"] == "skipped (dry-run)"
    with pytest.raises(SystemExit):
        weights_day.parse_args([])  # --checkpoints_dir outside --dry-run
    assert weights_day.parse_args(["--dry-run"]).device == "cuda"


def test_report_writer(tmp_path):
    report = {"dry_run": False, "wer": {"tiny": {"wer": 0.2, "target": 0.24, "pass": True},
                                        "base": {"wer": 0.3, "target": 0.18, "pass": False}}}
    weights_day.step5_record(_args(tmp_path), report)
    assert json.loads((tmp_path / "weights_day_report.json").read_text()) == report
    md = (tmp_path / "weights_day_report.md").read_text()
    assert "mode: REAL, device cpu" in md
    assert "| tiny | 0.2000 | 0.24 | True |" in md and "| base | 0.3000 | 0.18 | False |" in md
