"""On the card (marked ``cuda``; skipped elsewhere): each cell runs and
reads ``correct``, and the control at the cell's own sizes is not correct
by the harness's own checks on three seeds while the program is.

    python -m pytest portbench/tests -m cuda -p no:cacheprovider
"""

import json
import os
import subprocess
import sys

import pytest

from portbench import control, spec
from portbench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the chip")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "2147483749", "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limit_at_the_cells_size(card, workload):
    """The control in the program's place, judged by the harness's own
    checks and ``correct`` (both numbers, each against its limit), is not
    correct on any seed; the program is correct on every one."""
    cell = spec.load_cell(ROOT, workload)
    seconds = 10.0 if cell.traffic["kind"] == "serve" else 0.5
    rows = control.readings(cell, [2147483801, 2147483802, 2147483803], seconds, card, ROOT)
    verdicts = [(r["seed"], r["program_checks"], r["control_checks"]) for r in rows]
    assert all(r["program_correct"] for r in rows), verdicts
    assert not any(r["control_correct"] for r in rows), verdicts
