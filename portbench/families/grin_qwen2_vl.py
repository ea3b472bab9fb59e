"""The Uni-MoE-2.0-Omni family (``"model_type": "grin_qwen2_vl"``): its
speech-to-text path, a Whisper encoder feeding a decoder-only language
model with a mixture of fixed, routed and null experts in every block.

- ``dims``: the configuration's sizes and what it assumes, as
  ``omni_reference.OmniDims``.
- ``prompt_ids``: the prompt's text ids, drawn from the weight seed.
- ``judge``: the plain fp32 reference (``omni_reference.py``), each block's
  weights drawn as it reaches it, teacher-forced over each judged
  request's prompt and served ids, every id allowed; with ``control`` the
  reference in that precision beside it.
- ``port_model``: the port's ``models.omni.Omni`` built from the same
  draws, one weight at a time, in the precision the configuration serves.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from portbench.judge import Gaps, Served, gaps_below_best, masked, mean_logprob
from portbench.omni_reference import OmniDims, OmniReference, draw, prompt_ids

CONTROL = "int4"  # the configuration serves int8: the control is the precision below

__all__ = ["CONTROL", "dims", "judge", "port_model", "prompt_ids", "readings"]


def dims(config: dict) -> OmniDims:
    return OmniDims.from_config(config)


@torch.no_grad()
def judge(dims: OmniDims, weight_seed: int, served: Sequence[Served], device,
          control: Optional[str] = None) -> Gaps:
    """The reference's (and, with ``control``, the control's) reading of
    ``served``; weights drawn again from ``weight_seed`` on ``device``."""
    served = [s for s in served if len(s.tokens)]
    if not served:
        return Gaps(widest=math.inf, mean=math.inf, tokens=0, logprob_error=math.inf)
    prefix, suffix = prompt_ids(dims, weight_seed)
    clips = [s.audio for s in served]
    ref, toks, gaps, lp_err = readings(
        OmniReference(dims, weight_seed, device).logits(clips, prefix, suffix,
                                                        [s.tokens for s in served]),
        served, device)
    ok = torch.ones(dims.n_vocab, dtype=torch.bool, device=device)
    ctl_gaps, ctl_lp_err = [], []
    if control:
        ctl = OmniReference(dims, weight_seed, device, quant=control).logits(
            clips, prefix, suffix, [s.tokens for s in served])
        for r, c, t in zip(ref, ctl, toks):
            c = masked(c, ok, ok)
            ctl_gaps.append(gaps_below_best(r, c.argmax(dim=-1)))
            ctl_lp_err.append(abs(mean_logprob(c, t) - mean_logprob(r, t)))
    g = torch.cat(gaps)
    moved = (toks[0][:1] + 1) % dims.n_vocab  # the first judged id altered where it is produced
    fault = max(float(gaps_below_best(ref[0][:1], moved)[0]), float(g.max()))
    return Gaps(widest=float(g.max()), mean=float(g.mean()), tokens=int(g.numel()),
                logprob_error=max(lp_err),
                control=float(torch.cat(ctl_gaps).max()) if ctl_gaps else None,
                control_logprob_error=max(ctl_lp_err) if ctl_lp_err else None,
                fault=fault if control else None)


def readings(ref_logits: Sequence[torch.Tensor], served: Sequence[Served], device):
    """The reference's logits of each served request (every id allowed),
    its served ids, each id's gap below the reference's best, and each
    request's |program - reference| mean log-probability."""
    ok = torch.ones(ref_logits[0].shape[-1], dtype=torch.bool, device=device)
    ref = [masked(x, ok, ok) for x in ref_logits]
    toks = [torch.as_tensor(np.asarray(s.tokens, np.int64), device=device) for s in served]
    gaps = [gaps_below_best(r, t) for r, t in zip(ref, toks)]
    lp_err = [abs(s.avg_logprob - mean_logprob(r, t)) for s, r, t in zip(served, ref, toks)]
    return ref, toks, gaps, lp_err


def port_config(dims: OmniDims, name: str):
    """The port's ``OmniConfig`` of these sizes."""
    from whisper_tpu_torch.config import OmniConfig, WhisperConfig

    w = dims.whisper
    audio = WhisperConfig(name=name + "-audio", n_mels=w.n_mels, n_audio_ctx=w.n_audio_ctx,
                          n_audio_state=w.n_audio_state, n_audio_head=w.n_audio_head,
                          n_audio_layer=w.n_audio_layer)
    if w.n_audio_ffn != 4 * w.n_audio_state:
        raise ValueError("the port's encoder blocks take an MLP four times their width")
    return OmniConfig(name=name, audio=audio, n_query=dims.n_query, d_model=dims.d_model,
                      n_layer=dims.n_layer, n_head=dims.n_head, n_kv_head=dims.n_kv_head,
                      head_dim=dims.head_dim, n_vocab=dims.n_vocab, rms_eps=dims.rms_eps,
                      rope_theta=dims.rope_theta, n_fixed=dims.n_fixed, d_fixed=dims.d_fixed,
                      n_routed=dims.n_routed, d_routed=dims.d_routed, n_null=dims.n_null,
                      top_p=dims.top_p, top_k=dims.top_k, n_prefix=dims.n_prefix,
                      n_suffix=dims.n_suffix, n_text_ids=dims.n_text_ids, stop_id=dims.stop_id)


def port_model(dims: OmniDims, config: dict, seed: int, device):
    """The port's model over this benchmark's weights, quantized as it is
    built where the configuration serves int8."""
    from whisper_tpu_torch.models.omni import build_omni

    prec = config["precision"]
    dtype = getattr(torch, prec["compute_dtype"])
    return build_omni(port_config(dims, config["name"]),
                      lambda name, shape: draw(seed, name, shape, device), device,
                      dtype=dtype, quantize=prec["w8a8"])
