"""Weight quantization: symmetric int8 per output channel.

Port of ``whisper_tpu/ops/quant.py``. Attention and MLP matmul weights become
an int8 payload plus an fp32 scale per output channel; embeddings,
layernorms, biases and the conv stem stay in high precision. ``torch.round``
rounds half to even like ``jnp.round``, and the clip to +-127 and the 1e-8
floor on the channel maximum are kept, so the payloads agree with the JAX
package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass
class QTensor:
    """Symmetric per-output-channel int8 weight: w ~= q * s.

    ``q`` has the weight's own shape; ``s`` is fp32 with the contraction
    dims kept as 1 (a (d_in, d_out) weight has s of shape (1, d_out)).
    :meth:`k_major` stores a 2-D payload column-major, the layout the int8
    GEMM kernel reads."""

    q: torch.Tensor
    s: torch.Tensor

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.s.to(device))

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.s.to(dtype)

    def k_major(self) -> torch.Tensor:
        """The (d_in, d_out) payload stored column-major (the transpose of a
        contiguous (d_out, d_in)). The first call lays ``q`` out so, in
        place, and every later W8A8 product with this weight reads it as it
        is: one copy of the weight, made once."""
        if not self.q.t().is_contiguous():
            self.q = self.q.t().contiguous().t()
        return self.q


def quantize_weight(w: torch.Tensor, axis: int = -1,
                    batch_axes: Sequence[int] = ()) -> QTensor:
    """Symmetric int8 reducing over every dim except ``axis`` (the output
    channel) and ``batch_axes``."""
    ndim = w.dim()
    keep = {axis % ndim} | {a % ndim for a in batch_axes}
    red = tuple(i for i in range(ndim) if i not in keep)
    w32 = w.to(torch.float32)
    amax = torch.clamp(torch.amax(w32.abs(), dim=red, keepdim=True), min=1e-8)
    s = amax / 127.0
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QTensor(q, s)


# (module, weight) names quantized by quantize_params: every big matmul weight
QUANT_LINEARS = {("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                 ("cross", "wq"), ("cross", "wk"), ("cross", "wv"), ("cross", "wo"),
                 ("mlp", "w1"), ("mlp", "w2")}


def quantize_params(model):
    """Replace the attention/MLP weights of every block of ``model`` (a
    :class:`whisper_tpu_torch.models.model.Whisper`) with int8 QTensors, in
    place; returns the model. Each block's (d_in, d_out) weight gets a
    (1, d_out) scale, as the JAX package's stacked (L, 1, d_out) scales."""
    for blocks in (model.encoder.blocks, model.decoder.blocks):
        for blk in blocks:
            for mod_name, w_name in QUANT_LINEARS:
                mod = getattr(blk, mod_name, None)
                if mod is None:
                    continue
                w = mod[w_name]
                if not isinstance(w, QTensor):
                    mod[w_name] = quantize_weight(w, axis=-1)
    return model


def quantize_logits_emb(model):
    """Add an int8 per-vocab-row copy of the tied embedding for the logits
    matmul only (the embedding gather keeps the original table); in place,
    returns the model."""
    model.decoder.tok_emb_q8 = quantize_weight(model.decoder.tok_emb, axis=0)
    return model


def quantized_bytes(model) -> int:
    """Parameter bytes of ``model`` as the JAX package counts them: a
    QTensor's int8 payload and fp32 scales, every other parameter or buffer
    its elements times their size. The layout :meth:`QTensor.k_major` gives
    a payload replaces it in place, so nothing is counted twice."""
    leaves = [val for _, _, val in model.leaves()]
    if model.decoder.tok_emb_q8 is not None:
        leaves.append(model.decoder.tok_emb_q8)
    total = 0
    for leaf in leaves:
        if isinstance(leaf, QTensor):
            total += leaf.q.numel() + leaf.s.numel() * 4
        else:
            total += leaf.numel() * leaf.element_size()
    return total
