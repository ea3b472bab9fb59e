"""Model state for the port: a bridge from the JAX pytree, and a seeded init.

``from_jax_params`` turns the JAX package's parameter pytree (leaves as numpy
arrays; a ``QTensor`` as any object with ``q`` and ``s``) into a
:class:`~whisper_tpu_torch.models.model.Whisper`: stacked (L, ...) leaves
become per-block tensors, int8 payloads keep their per-layer (1, d_out) fp32
scales, and the conv weights go from JAX's WIO (3, C_in, C_out) to torch's
(C_out, C_in, 3).

``init_params`` is the port's own random init, with the same shapes and
scales as the JAX ``init_params`` (but other numbers: it draws from a
``torch.Generator``). Both build the weights on ``device``, which the
caller always names: nothing lands on the CPU unless asked for.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import WhisperConfig
from .models.model import Decoder, Encoder, Whisper, sinusoids
from .ops.quant import QTensor


def _is_qtensor(x) -> bool:
    return hasattr(x, "q") and hasattr(x, "s")


def _tensor(x, device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: numpy has no native one
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _leaf(x, device, layer=None):
    """One leaf (optionally the ``layer``-th slice of a stacked one)."""
    if _is_qtensor(x):
        q, s = np.asarray(x.q), np.asarray(x.s, np.float32)
        if layer is not None:
            q, s = q[layer], s[layer]
        return QTensor(_tensor(q, device), _tensor(s, device))
    a = np.asarray(x)
    return _tensor(a[layer] if layer is not None else a, device)


def _unstack(tree: Dict[str, Any], n_layers: int, device):
    """Stacked block dict {sublayer: {name: (L, ...)}} -> per-block dicts."""
    return [{sub: {k: _leaf(v, device, l) for k, v in leaves.items()}
             for sub, leaves in tree.items()} for l in range(n_layers)]


def _conv(p, device) -> Dict[str, torch.Tensor]:
    return {"w": _tensor(np.asarray(p["w"]).transpose(2, 1, 0), device),
            "b": _leaf(p["b"], device)}


def from_jax_params(tree: Dict[str, Any], cfg: WhisperConfig, *, device) -> Whisper:
    """JAX pytree (numpy leaves) -> the port's :class:`Whisper` on ``device``."""
    enc, dec = tree["encoder"], tree["decoder"]
    encoder = Encoder(
        conv1=_conv(enc["conv1"], device),
        conv2=_conv(enc["conv2"], device),
        pos_emb=_leaf(enc["pos_emb"], device),
        ln_post={k: _leaf(v, device) for k, v in enc["ln_post"].items()},
        blocks=_unstack(enc["blocks"], cfg.n_audio_layer, device),
    )
    decoder = Decoder(
        tok_emb=_leaf(dec["tok_emb"], device),
        pos_emb=_leaf(dec["pos_emb"], device),
        ln={k: _leaf(v, device) for k, v in dec["ln"].items()},
        blocks=_unstack(dec["blocks"], cfg.n_text_layer, device),
        tok_emb_q8=_leaf(dec["tok_emb_q8"], device) if "tok_emb_q8" in dec else None,
    )
    return Whisper(cfg, encoder, decoder)


def init_params(cfg: WhisperConfig, seed: int = 0, *, device) -> Whisper:
    """Seeded random init with the JAX init's shapes and scales: N(0, 1/d_in)
    matmul weights, zero biases, unit LayerNorm gains, N(0, 0.01^2) decoder
    positions, sinusoidal encoder positions."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device, dtype=f32) * scale

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=f32)

    def ln(d):
        return {"g": torch.ones(d, device=device, dtype=f32), "b": zeros(d)}

    def attn(d):
        return {"wq": normal((d, d), d ** -0.5), "bq": zeros(d),
                "wk": normal((d, d), d ** -0.5),
                "wv": normal((d, d), d ** -0.5), "bv": zeros(d),
                "wo": normal((d, d), d ** -0.5), "bo": zeros(d)}

    def mlp(d):
        return {"w1": normal((d, 4 * d), d ** -0.5), "b1": zeros(4 * d),
                "w2": normal((4 * d, d), (4 * d) ** -0.5), "b2": zeros(d)}

    D, Dt = cfg.n_audio_state, cfg.n_text_state
    encoder = Encoder(
        conv1={"w": normal((D, cfg.n_mels, 3), (3 * cfg.n_mels) ** -0.5), "b": zeros(D)},
        conv2={"w": normal((D, D, 3), (3 * D) ** -0.5), "b": zeros(D)},
        pos_emb=torch.from_numpy(sinusoids(cfg.n_audio_ctx, D)).to(device),
        ln_post=ln(D),
        blocks=[{"attn_ln": ln(D), "attn": attn(D), "mlp_ln": ln(D), "mlp": mlp(D)}
                for _ in range(cfg.n_audio_layer)],
    )
    decoder = Decoder(
        tok_emb=normal((cfg.n_vocab, Dt), Dt ** -0.5),
        pos_emb=normal((cfg.n_text_ctx, Dt), 0.01),
        ln=ln(Dt),
        blocks=[{"attn_ln": ln(Dt), "attn": attn(Dt), "cross_ln": ln(Dt),
                 "cross": attn(Dt), "mlp_ln": ln(Dt), "mlp": mlp(Dt)}
                for _ in range(cfg.n_text_layer)],
    )
    return Whisper(cfg, encoder, decoder)
