"""A model of another family is added as files: a copy of ``portbench/`` and
``BENCHMARK.json`` gains a toy family, its configuration, a driver, a
traffic mix, limits and entries, and nothing else; in a fresh interpreter
rooted at the copy the harness runs the toy cell on the CPU to ``correct``
true, and with one served token moved in the toy program to false."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tests.tiny import ROOT

TOY_FAMILY = '''"""A toy family: a one-layer recurrent decoder over seeded random weights,
started from its input's band energies; all its tokens allowed."""

from dataclasses import dataclass

import numpy as np
import torch

from portbench.judge import Gaps, gaps_below_best, masked, mean_logprob

CONTROL = "bfloat16"
BOS = 0


@dataclass(frozen=True)
class ToyDims:
    vocab: int
    width: int
    bands: int


def dims(config):
    return ToyDims(config["vocab_size"], config["hidden_size"], config["bands"])


def make_weights(d, seed, device):
    shapes = {"emb": (d.vocab, d.width), "rec": (d.width, d.width),
              "inp": (d.bands, d.width), "out": (d.width, d.vocab)}
    scale = {"emb": 1.0, "rec": d.width ** -0.5, "inp": d.bands ** -0.5, "out": 1.0}
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    buf = torch.randn(sum(a * b for a, b in shapes.values()), generator=gen, device=device)
    parts = torch.split(buf, [a * b for a, b in shapes.values()])
    return {k: p.view(shapes[k]) * scale[k] for k, p in zip(shapes, parts)}


def features(clip, bands):
    x = torch.as_tensor(np.asarray(clip[: len(clip) // bands * bands], np.float32))
    return 10.0 * x.view(bands, -1).pow(2).mean(1).sqrt()


class ToyProgram:
    """The program under test: a batched greedy decode in float32."""

    def __init__(self, w):
        self.w = w

    def generate(self, clips, n):
        w = self.w
        c = torch.stack([features(x, w["inp"].shape[0]) for x in clips]) @ w["inp"]
        h, tok, toks, lp = torch.zeros_like(c), torch.full((len(clips),), BOS), [], 0.0
        for _ in range(n):
            h = torch.tanh(w["emb"][tok] + h @ w["rec"] + c)
            logp = torch.log_softmax(h @ w["out"], dim=-1)
            tok = logp.argmax(dim=-1)
            toks.append(tok)
            lp = lp + logp.gather(1, tok[:, None])[:, 0]
        return torch.stack(toks, 1).numpy(), (lp / n).numpy()


def _logits(w, served):
    """The plain reference in float64, one request and one position at a time."""
    c = features(served.audio, w["inp"].shape[0]).double() @ w["inp"]
    h, rows = torch.zeros_like(c), []
    for t in [BOS] + [int(t) for t in served.tokens[:-1]]:
        h = torch.tanh(w["emb"][t] + h @ w["rec"] + c)
        rows.append(h @ w["out"])
    return torch.stack(rows)


@torch.no_grad()
def judge(dims, weight_seed, served, device, control=None):
    w = make_weights(dims, weight_seed, device)
    ref = {k: v.double() for k, v in w.items()}
    ctl = {k: v.to(getattr(torch, control)).double() for k, v in w.items()} if control else None
    ok = torch.ones(dims.vocab, dtype=torch.bool)
    gaps, lp_err, ctl_gaps, ctl_lp_err = [], [], [], []
    for s in served:
        toks = torch.as_tensor(np.asarray(s.tokens, np.int64))
        m = masked(_logits(ref, s), ok, ok)
        gaps.append(gaps_below_best(m, toks))
        lp_err.append(abs(s.avg_logprob - mean_logprob(m, toks)))
        if ctl:
            cm = masked(_logits(ctl, s), ok, ok)
            ctl_gaps.append(gaps_below_best(m, cm.argmax(dim=-1)))
            ctl_lp_err.append(abs(mean_logprob(cm, toks) - mean_logprob(m, toks)))
    g = torch.cat(gaps)
    return Gaps(widest=float(g.max()), mean=float(g.mean()), tokens=int(g.numel()),
                logprob_error=max(lp_err),
                control=float(torch.cat(ctl_gaps).max()) if ctl_gaps else None,
                control_logprob_error=max(ctl_lp_err) if ctl_lp_err else None)


def port_model(dims, config, seed, device):
    return ToyProgram(make_weights(dims, seed, device))
'''

TOY_DRIVER = '''"""Batches of seeded noise inputs through the toy program, back to back."""

import time

from .. import generate
from ..harness import Context, Outcome
from ..judge import Served


def run(ctx: Context) -> Outcome:
    mix = ctx.cell.traffic
    model = ctx.cell.family.port_model(ctx.dims, ctx.cell.config, ctx.weight_seed, ctx.device)
    clips = generate.noise(ctx.seed, [mix["samples"]] * mix["batch"], mix["amplitude"],
                           ctx.device)
    model.generate(clips, mix["new_tokens"])
    setup_s = time.perf_counter() - ctx.t0
    finished, t0 = [], time.perf_counter()
    while not finished or time.perf_counter() - t0 < ctx.seconds:
        toks, lps = model.generate(clips, mix["new_tokens"])
        finished += [Served(audio=c, language="", tokens=t, avg_logprob=float(lp))
                     for c, t, lp in zip(clips, toks, lps)]
    wall = time.perf_counter() - t0
    audio_s = len(finished) * mix["samples"] / generate.SAMPLE_RATE
    return Outcome(setup_s=setup_s, end_to_end={"audio_s_per_s": audio_s / wall},
                   attempted=len(finished), failed=0, finished=finished)
'''

ADDED = {
    "families/toy.py": TOY_FAMILY,
    "drivers/toy.py": TOY_DRIVER,
    "configs/toy.json": json.dumps({"name": "toy", "source": "seeded random weights",
                                    "model_type": "toy", "vocab_size": 32, "hidden_size": 16,
                                    "bands": 8, "reduced": []}),
    "traffic/toy-batch.json": json.dumps({"kind": "toy", "batch": 4, "samples": 1600,
                                          "new_tokens": 8, "amplitude": 0.1,
                                          "judge_requests": 4}),
    "limits/toy-batch.json": json.dumps({"max_logit_gap": {"limit": 1e-4},
                                         "max_logprob_error": {"limit": 1e-4}}),
}

# the fault moves row 0's first token in every batch; the judged sample always
# holds the longest request, where all tie the first, so a moved token is judged
RUN = '''
import contextlib, io, json, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from portbench import harness, spec
assert spec.__file__.startswith(root), spec.__file__

def run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", "toy-batch", "--seed", "2147483749", "--seconds", "0.2",
                           "--trace", "0"], root=root, t0=time.perf_counter(),
                          device=torch.device("cpu"))
    assert rc == 0
    return json.loads(out.getvalue().splitlines()[-1])

sound = run()
program = spec.family("toy").ToyProgram
real = program.generate

def moved(self, clips, n):
    toks, lps = real(self, clips, n)
    toks[0, 0] = (toks[0, 0] + 1) % self.w["emb"].shape[0]
    return toks, lps

program.generate = moved
print(json.dumps({"sound": sound, "moved": run(), "port": "whisper_tpu_torch" in sys.modules}))
'''


def _files(root):
    out = {}
    for folder, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if not f.endswith(".pyc"):
                path = os.path.join(folder, f)
                out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def test_a_family_is_added_as_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in ADDED.items():
        (tmp_path / "portbench" / rel).write_text(text)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "toy", "source": "seeded random weights",
                             "file": "portbench/configs/toy.json", "reduced": [],
                             "why": "a model that is not Whisper"})
    bench["workloads"].append({"name": "toy-batch", "config": "toy", "traffic": "toy-batch",
                               "chips": 1, "why": "batches of 4 toy requests"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["audio_s_per_s"]["workloads"].append("toy-batch")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, check=True,
                         env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    sound, moved = got["sound"], got["moved"]
    assert sound["correct"] and sound["judge"]["tokens"] > 0, sound
    assert set(sound["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert not moved["correct"], moved
    assert moved["checks"]["max_logit_gap"]["value"] > moved["checks"]["max_logit_gap"]["limit"]
    assert not got["port"]  # the toy cell ran without the port

    tree, copy = _files(os.path.join(ROOT, "portbench")), _files(tmp_path / "portbench")
    assert set(copy) - set(tree) == set(ADDED) and set(tree) <= set(copy)
    assert all(copy[rel] == body for rel, body in tree.items())
