"""Default-path walls, or kernel phases, of several checkouts of the port,
in turns, on one card.

    python3 chip_walls.py PARENT . . PARENT
    python3 chip_walls.py --phases kernel_k1,kernel_k6 PARENT . . PARENT
    python3 chip_walls.py --paths serving_ladder,beam_phase,serving_beam PARENT . . PARENT
    python3 chip_walls.py --ladder PARENT . . PARENT
    python3 chip_walls.py --omni_ids SEED PARENT . . PARENT

Each argument is the root of a checkout (a directory holding
``chip_smoke.py`` and ``whisper_tpu_torch/``, e.g. the parent commit
unpacked with ``git archive`` into a git-ignored directory). For each, in
the order given and in a process of its own, it builds that checkout's
kernels and runs its ``chip_smoke.end_to_end`` (turbo B64/T64, kvq + skvq +
w8a8, bf16) and ``chip_smoke.serving`` (the server's zero-flag defaults
with the temperature ladder off, 24 clips) phases, and prints one JSON line with the offline wall and the
serving burst's wall and latencies. With ``--phases`` it runs the named
kernel phases of the ``chip_smoke.py`` beside this script on that
checkout's kernels instead (each checks its kernel against the plain
version through the wrappers), so every checkout is timed by the same
code, and prints their times. With ``--paths`` it runs the named path
phases of each checkout's own ``chip_smoke.py`` (each takes the kernel
counters, checks its outputs and launches the checkout's way) and prints
their walls and latencies. With ``--ladder`` it runs the ``chip_smoke.py``
beside this script's ``shrinking_ladder_walls`` on that checkout (the
offline configuration with its temperature ladder on, each rung
re-decoding a seeded shrinking subset of the rows) and prints the walls of
its batches. With ``--omni_ids SEED`` it builds the ``uni-moe-offline-b64``
cell's pipeline as the benchmark does for ``--seed SEED`` (its weights,
prompt and precision) on that checkout, decodes the cell's two batches and
the first again, and prints a digest of the served ids, whether the
repeat gave the first batch's ids, and whether the digest equals the first
checkout's. Comparing two
commits in one call on one card, in turns, keeps other cards' power limits
and other hosts' neighbours out of the difference. Needs a CUDA card; exits
non-zero if a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# the kernel phases, one measurement for every checkout
SMOKE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")

_RUN = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from whisper_tpu_torch.ops import _build, decode_attention, flash_attention, int8_gemm, log10_mel

names = ("flash_attention_btd", "flash_attention", "cross_attention_decode_fd",
         "cross_attention_decode", "cross_attention_decode_dense", "self_attention_decode",
         "self_attention_decode_int8", "flash_attention_btd_sharded")
counters = [getattr(m, n) for n in names for m in (decode_attention, flash_attention)
            if hasattr(m, n)] + [int8_gemm.int8_gemm, log10_mel.log10_mel]
if importlib.util.find_spec("whisper_tpu_torch.ops.quantize_rows"):  # K8q, where it exists
    from whisper_tpu_torch.ops.quantize_rows import quantize_rows
    counters.append(quantize_rows)
if importlib.util.find_spec("whisper_tpu_torch.ops.layer_norm_rows"):  # K8n, where it exists
    from whisper_tpu_torch.ops.layer_norm_rows import layer_norm_rows
    counters.append(layer_norm_rows)
torch.backends.cuda.matmul.allow_tf32 = False
build = _build.build_all()
e2e, _ = cs.end_to_end(counters)
torch.cuda.empty_cache()
# the greedy core (a checkout with the ladder passes --temperature_fallback '')
served = cs.serving(counters, getattr(cs, "GREEDY", ()))
print("RESULT " + json.dumps({
    "offline_wall_s": e2e["wall_s"], "offline_steps": e2e["decode_steps"],
    "serving_wall_s": served["wall_s"], "serving_p50_s": served["latency_p50_s"],
    "serving_p95_s": served["latency_p95_s"], "serving_steps": served["steps"],
    "serving_admission_batches": served["admission_batches"], **build}))
"""

_PHASES = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[3])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from whisper_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
build = _build.build_all()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
out = {}
for phase in sys.argv[2].split(","):
    rec = getattr(cs, phase)(dev, gen)
    out[phase] = {k: rec[k] for k in ("ms", "device_ms", "library_ms", "bound_ms",
                                      "max_abs_err", "cases") if k in rec}
    torch.cuda.empty_cache()
print("RESULT " + json.dumps({"phases": out, **build}))
"""


_PATHS = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from whisper_tpu_torch.ops import _build
from whisper_tpu_torch.utils.graphs import kernel_wrappers

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build = _build.build_all()
counters = kernel_wrappers()
keys = ("wall_s", "greedy_wall_s", "latency_p50_s", "latency_p95_s", "latency_beam_p50_s",
        "latency_beam_p95_s", "latency_greedy_p50_s", "steps", "device_steps", "host_syncs",
        "aux_batches", "aux_steps", "aux_graphs")
out = {}
for phase in sys.argv[2].split(","):
    rec = getattr(cs, phase)(counters)
    out[phase] = {k: rec[k] for k in keys if k in rec}
    torch.cuda.empty_cache()
print("RESULT " + json.dumps({"paths": out, **build}, default=str))
"""


_LADDER = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from whisper_tpu_torch.ops import _build

torch.backends.cuda.matmul.allow_tf32 = False
build = _build.build_all()
print("RESULT " + json.dumps({"ladder": cs.shrinking_ladder_walls(), **build}))
"""


_OMNI_IDS = r"""
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from portbench import generate, spec
from whisper_tpu_torch.omni import OmniPipeline
from whisper_tpu_torch.ops import _build

build = _build.build_all()
cell, seed, dev = spec.load_cell(sys.argv[1], "uni-moe-offline-b64"), int(sys.argv[2]), torch.device("cuda")
dims, mix = cell.family.dims(cell.config), cell.traffic
weight_seed = generate.stream_seed(seed, generate.WEIGHTS)
prefix, suffix = cell.family.prompt_ids(dims, weight_seed)
pipe = OmniPipeline(params=cell.family.port_model(dims, cell.config, weight_seed, dev),
                    prefix_ids=prefix, suffix_ids=suffix, max_tokens=mix["new_tokens"], device=dev,
                    **cell.config["precision"])
batches = generate.offline_batches(mix, seed, dev)
served = [[r.tokens for r in pipe.transcribe_batch(clips)] for clips in batches + batches[:1]]
digest = hashlib.sha256()
for tokens in served[:-1]:
    for t in tokens:
        digest.update(np.asarray(t, dtype=np.int64).tobytes() + b"|")
print("RESULT " + json.dumps({
    "ids_sha256": digest.hexdigest(), "ids": sum(len(t) for b in served[:-1] for t in b),
    "repeat_equal": all(np.array_equal(x, y) for x, y in zip(served[0], served[-1])), **build}))
"""


def main(argv) -> int:
    phases = paths = omni_seed = None
    ladder = argv[:1] == ["--ladder"]
    if ladder:
        argv = argv[1:]
    elif argv[:1] == ["--omni_ids"] and len(argv) > 1:
        omni_seed, argv = argv[1], argv[2:]
    elif argv[:1] == ["--phases"] and len(argv) > 1:
        phases, argv = argv[1], argv[2:]
    elif argv[:1] == ["--paths"] and len(argv) > 1:
        paths, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    first = None  # the first checkout's ids (--omni_ids)
    for i, root in enumerate(argv):
        root = os.path.abspath(root)
        if ladder:
            cmd = [sys.executable, "-c", _LADDER, root, SMOKE]
        elif omni_seed is not None:
            cmd = [sys.executable, "-c", _OMNI_IDS, root, omni_seed]
        elif paths is not None:
            cmd = [sys.executable, "-c", _PATHS, root, paths]
        elif phases is not None:
            cmd = [sys.executable, "-c", _PHASES, root, phases, SMOKE]
        else:
            cmd = [sys.executable, "-c", _RUN, root]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(lines[-1][len("RESULT "):])
        if omni_seed is not None:
            first = first or rec["ids_sha256"]
            rec["equal_to_first"] = rec["ids_sha256"] == first
        print(json.dumps({"turn": i, "checkout": argv[i], "card": smi, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
