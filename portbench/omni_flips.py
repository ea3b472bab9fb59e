"""The share of routing choices in which the program and the plain
reference differ, for Uni-MoE-2.0-Omni's offline cell, on a CUDA card:
the program (the cell's configuration, built by its family) serves a batch
of the cell's clips; its eager prefill and its steps, teacher-forced over
the ids it served, give every token's chosen experts at every layer (read
by wrapping the router); then, the program freed, the fp32 reference
records its own over the same ids, and its logits give the judge's two
numbers for the served ids.

    python3 portbench/omni_flips.py --seed 2600000001 --clips 8 [--w8a8 0]

``--w8a8 0`` builds the program's linears in the compute dtype (bf16
weights) in place of the configuration's W8A8, as a witness of how much
of the difference the int8 products make. Prints one JSON line: the
precision, the decisions compared and the share that differ, in the
prefill and in the decode, how many differ in the set's size or in the
null expert, and the widest gap and log-probability error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
from unittest import mock

import torch


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root
    from portbench import generate, spec
    from portbench.judge import Served
    from portbench.omni_reference import OmniReference

    p = argparse.ArgumentParser("portbench/omni_flips.py")
    p.add_argument("--workload", default="uni-moe-offline-b64")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--clips", type=int, default=8)
    p.add_argument("--w8a8", type=int, choices=(0, 1), default=None,
                   help="override the configuration's W8A8 (0: linears in the compute dtype)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("omni_flips.py measures the program on a CUDA card; none is here", file=sys.stderr)
        return 2
    cell = spec.load_cell(root, args.workload)
    config = cell.config
    if args.w8a8 is not None:
        config = dict(config, precision=dict(config["precision"], w8a8=bool(args.w8a8)))
    dev = torch.device("cuda", 0)
    dims, fam = cell.family.dims(cell.config), cell.family
    wseed = generate.stream_seed(args.seed, generate.WEIGHTS)
    clips = generate.offline_batches(dict(cell.traffic, batch=args.clips, distinct_batches=1),
                                     args.seed, dev)[0]
    prefix, suffix = fam.prompt_ids(dims, wseed)
    with torch.no_grad():
        program = program_choices(fam.port_model(dims, config, wseed, dev), config,
                                  cell.traffic["new_tokens"], clips, prefix, suffix)
        gc.collect()
        torch.cuda.empty_cache()
        ref = []
        logits = OmniReference(dims, wseed, dev).logits(clips, prefix, suffix, program["served"],
                                                        record=ref)
        served = [Served(audio=c, language="", tokens=t, avg_logprob=lp)
                  for c, t, lp in zip(clips, program["served"], program["avg_logprob"])]
        _, _, gaps, lp_err = fam.readings(logits, served, dev)
    out = {"seed": args.seed, "precision": config["precision"],
           "device": torch.cuda.get_device_name(dev), **compare(dims, program, ref, len(clips)),
           "max_logit_gap": float(torch.cat(gaps).max()), "max_logprob_error": max(lp_err),
           "ids": int(sum(len(t) for t in program["served"]))}
    print(json.dumps(out))
    return 0


@contextlib.contextmanager
def routes():
    """Each call of the port's router in the block: its chosen sets (N, E)
    bool, in call order."""
    from whisper_tpu_torch.models import omni

    got, route = [], omni.route

    def recording(p, top_p, top_k):
        got.append(route(p, top_p, top_k))
        return got[-1]

    with mock.patch.object(omni, "route", recording):
        yield got


def program_choices(model, config, n, clips, prefix, suffix) -> dict:
    from whisper_tpu_torch.models.omni import new_cache, prefill, step
    from whisper_tpu_torch.omni import OmniPipeline

    pipe = OmniPipeline(params=model, prefix_ids=prefix, suffix_ids=suffix, max_tokens=n,
                        device=model.device, **config["precision"])
    results = pipe.transcribe_batch(clips)
    served = [r.tokens for r in results]
    dt = pipe.compute_dtype
    _, x = pipe.embed_audio(clips)
    kv = new_cache(model, len(clips), -(-(model.cfg.prompt_len + n) // 128) * 128, dt)
    P, L = model.cfg.prompt_len, model.cfg.n_layer
    steps = min(len(t) for t in served) - 1
    toks = torch.stack([torch.as_tensor(t[: steps + 1], device=model.device) for t in served])
    with routes() as rec:
        prefill(model, x, kv, dt)
        for i in range(steps):
            step(model, toks[:, i], torch.tensor(P + i, device=model.device), kv, dt)
    return {"served": served, "avg_logprob": [r.avg_logprob for r in results],
            "prefill": [r.cpu() for r in rec[:L]], "decode": [r.cpu() for r in rec[L:]],
            "steps": steps}


def compare(dims, program: dict, ref: list, B: int) -> dict:
    P, L = dims.prompt_len, dims.n_layer
    S = P + max(len(t) for t in program["served"]) - 1
    out = {}
    for phase in ("prefill", "decode"):
        n = diff = size = null = 0
        for layer in range(L):
            full = ref[layer].cpu().view(B, S, -1)
            if phase == "prefill":
                pairs = [(program["prefill"][layer].view(B, P, -1), full[:, :P])]
            else:
                pairs = [(program["decode"][i * L + layer], full[:, P + i])
                         for i in range(program["steps"])]
            for a, b in pairs:
                a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
                n += a.shape[0]
                diff += int((a != b).any(-1).sum())
                size += int((a.sum(-1) != b.sum(-1)).sum())
                null += int((a[:, dims.n_routed:] != b[:, dims.n_routed:]).any(-1).sum())
        out[phase] = {"decisions": n, "differ": diff, "share": diff / n if n else None,
                      "differ_in_size": size, "differ_in_null": null}
    return out


if __name__ == "__main__":
    sys.exit(main())
