"""Placement on a (data, model) mesh: the split of a model over its MODEL
axis, one copy of that split per DATA row.

Port of ``whisper_tpu/parallel/sharding.py``. The JAX package places a
parameter pytree onto a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. Here the engine is one process too, with an explicit mesh:
:func:`shard_params` turns a :class:`~whisper_tpu_torch.models.model.Whisper`
into a :class:`~whisper_tpu_torch.models.model.ShardedWhisper`, one
``Whisper`` of local heads and MLP columns per rank on its device, and the
model code runs the ranks of each layer in turn and sums the row-parallel
partial products in rank order (``models/model.py``). The sharded model
carries its mesh, so the JAX package's process-wide ``set_active_mesh``
(read by its kernel dispatch while tracing) has no counterpart here. On a
mesh with more than one data row it returns a
:class:`~whisper_tpu_torch.models.model.DataParallelWhisper`: one
``ShardedWhisper`` per row, on that row's devices, and the model code
splits every batch over the rows (``data_specs``: batch over DATA).

The specs keep the JAX tree and its axis names, as tuples in place of
``PartitionSpec``: block leaves are stacked (L, ...) in the JAX tree, so
their specs lead with ``None``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import WhisperConfig
from ..models.model import DataParallelWhisper, Decoder, Encoder, ShardedWhisper, Whisper
from ..ops.quant import QTensor

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


class Mesh:
    """A (data, model) grid of torch devices: ``devices[d, m]`` and
    ``shape[axis]``, as ``jax.sharding.Mesh`` reads."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, MODEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def model_devices(self) -> list:
        """The devices of the first data row, in model-rank order."""
        return list(self.devices[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh. Without ``devices`` it takes the distinct
    CUDA cards (the first ``n_data * n_model`` of them) and refuses too
    few, as the JAX package asserts. An explicit ``devices`` list is used
    as it is and may name one device more than once: those ranks then share
    it (``make_mesh(1, 2, devices=["cuda:0", "cuda:0"])`` runs two ranks on
    one card). Defaults: all devices on the data axis."""
    explicit = devices is not None
    devices = ([torch.device(d) for d in devices] if explicit else
               [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    n = len(devices)
    if n_data is None:
        n_data = max(n // n_model, 1)
    want = n_data * n_model
    if not explicit and want < n:
        devices = devices[:want]  # explicit shape: use the first N devices
        n = want
    if want != n:
        raise ValueError(f"{n_data}x{n_model} != {n} devices"
                         + ("" if explicit else " (CUDA cards)"))
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n_data, n_model))


def _attn_specs() -> Dict[str, Spec]:
    """Head-sharded attention: out-dims of q/k/v over MODEL, in-dim of o."""
    return {"wq": (None, None, MODEL_AXIS), "bq": (None, MODEL_AXIS),
            "wk": (None, None, MODEL_AXIS), "wv": (None, None, MODEL_AXIS),
            "bv": (None, MODEL_AXIS), "wo": (None, MODEL_AXIS, None), "bo": (None, None)}


def _mlp_specs() -> Dict[str, Spec]:
    return {"w1": (None, None, MODEL_AXIS), "b1": (None, MODEL_AXIS),
            "w2": (None, MODEL_AXIS, None), "b2": (None, None)}


def _ln_specs() -> Dict[str, Spec]:
    return {"g": (None, None), "b": (None, None)}


def param_specs(cfg: WhisperConfig) -> Dict[str, Any]:
    """Spec tree matching the JAX ``init_params`` structure."""
    return {
        "encoder": {
            "conv1": {"w": (), "b": ()},
            "conv2": {"w": (), "b": ()},
            "pos_emb": (),
            "blocks": {"attn_ln": _ln_specs(), "attn": _attn_specs(),
                       "mlp_ln": _ln_specs(), "mlp": _mlp_specs()},
            "ln_post": {"g": (), "b": ()},
        },
        "decoder": {
            # vocab-dim sharding keeps the (V, D) embedding distributed
            "tok_emb": (MODEL_AXIS, None),
            "pos_emb": (),
            "blocks": {"attn_ln": _ln_specs(), "attn": _attn_specs(),
                       "cross_ln": _ln_specs(), "cross": _attn_specs(),
                       "mlp_ln": _ln_specs(), "mlp": _mlp_specs()},
            "ln": {"g": (), "b": ()},
        },
    }


def data_specs() -> Dict[str, Spec]:
    """Activation specs: batch over DATA, width over MODEL where it helps."""
    return {
        "mel": (DATA_AXIS, None, None),
        "tokens": (DATA_AXIS, None),
        "audio": (DATA_AXIS, None, None),
        # head-major caches (L, B, H, T, dh): batch over data, heads over model
        "kv": (None, DATA_AXIS, MODEL_AXIS, None, None),
        "cross_kv": (None, DATA_AXIS, MODEL_AXIS, None, None),
        "logits": (DATA_AXIS, None, None),
    }


def _fit_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop spec axes that don't evenly divide the dim (replicate instead):
    e.g. tok_emb's vocab dim 51865 = 5x11x23x41 never divides the TP
    degree, and turbo's 51866 = 2 x 25933 splits at tp 2 only."""
    out = []
    for i, ax in enumerate(spec):
        if ax is not None and i < len(shape) and shape[i] % mesh.shape[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def _split(x: torch.Tensor, spec: Spec, mesh, rank: int, device) -> torch.Tensor:
    """Rank ``rank``'s block of ``x`` under ``spec`` (fitted to x's shape),
    as a contiguous copy on ``device``; the whole of ``x`` where the spec
    splits nothing."""
    spec = _fit_spec(spec, x.shape, mesh)
    if MODEL_AXIS not in spec:
        return x.to(device)
    dim = spec.index(MODEL_AXIS)
    n = x.shape[dim] // mesh.shape[MODEL_AXIS]
    return x.narrow(dim, rank * n, n).contiguous().to(device)


def _leaf(x, spec: Spec, mesh, rank: int, device):
    """A tensor or a QTensor (payload and scale split alike, each fitted to
    its own shape, as the JAX ``shard_params``)."""
    if isinstance(x, QTensor):
        return QTensor(_split(x.q, spec, mesh, rank, device),
                       _split(x.s, spec, mesh, rank, device))
    return _split(x, spec, mesh, rank, device)


def _dict(d: Dict[str, Any], specs: Dict[str, Spec], mesh, rank: int, device,
          stacked: bool) -> Dict[str, Any]:
    """A sublayer dict; ``stacked`` specs lead with the layer axis, which a
    port block does not have."""
    return {k: _leaf(v, specs[k][1:] if stacked else specs[k], mesh, rank, device)
            for k, v in d.items()}


def shard_params(model: Whisper, mesh):
    """Split ``model`` over the MODEL axis of ``mesh`` per
    :func:`param_specs`: column-parallel ``wq/bq/wk/wv/bv/w1/b1``,
    row-parallel ``wo/w2`` (``bo/b2`` replicated and added once after the
    sum), ``tok_emb`` and ``tok_emb_q8`` over the vocabulary where
    :func:`_fit_spec` lets it divide (and the MODEL axis has more than one
    rank), the rest replicated; QTensor payloads and scales split like the
    weight they belong to. Each rank's weights are copies on its device.

    One data row (``n_data == 1``) gives a :class:`ShardedWhisper` on
    ``mesh.devices[0, :]``; several give a :class:`DataParallelWhisper`
    holding one such split per row, row d's on ``mesh.devices[d, :]``, as
    the JAX ``shard_params`` replicates every parameter over DATA."""
    cfg = model.cfg
    tp = mesh.shape[MODEL_AXIS]
    for what, n_head in (("n_audio_head", cfg.n_audio_head), ("n_text_head", cfg.n_text_head)):
        if n_head % tp:
            raise ValueError(f"{what}={n_head} not divisible by TP={tp}")
    rows = [_shard_row(model, mesh, list(mesh.devices[d])) for d in range(mesh.shape[DATA_AXIS])]
    return rows[0] if len(rows) == 1 else DataParallelWhisper(cfg, rows, mesh)


def _shard_row(model: Whisper, mesh, devices) -> ShardedWhisper:
    """One data row's split of ``model``: rank r's weights on ``devices[r]``."""
    cfg = model.cfg
    specs = param_specs(cfg)
    es, ds = specs["encoder"], specs["decoder"]
    enc, dec = model.encoder, model.decoder
    vocab_split = (mesh.shape[MODEL_AXIS] > 1
                   and MODEL_AXIS in _fit_spec(ds["tok_emb"], dec.tok_emb.shape, mesh))
    shards = []
    for r, dev in enumerate(devices):
        encoder = Encoder(
            conv1=_dict(enc.conv1, es["conv1"], mesh, r, dev, False),
            conv2=_dict(enc.conv2, es["conv2"], mesh, r, dev, False),
            pos_emb=_leaf(enc.pos_emb, es["pos_emb"], mesh, r, dev),
            ln_post=_dict(enc.ln_post, es["ln_post"], mesh, r, dev, False),
            blocks=[{name: _dict(d, es["blocks"][name], mesh, r, dev, True)
                     for name, d in blk.sublayers().items()} for blk in enc.blocks])
        decoder = Decoder(
            tok_emb=_leaf(dec.tok_emb, ds["tok_emb"], mesh, r, dev),
            pos_emb=_leaf(dec.pos_emb, ds["pos_emb"], mesh, r, dev),
            ln=_dict(dec.ln, ds["ln"], mesh, r, dev, False),
            blocks=[{name: _dict(d, ds["blocks"][name], mesh, r, dev, True)
                     for name, d in blk.sublayers().items()} for blk in dec.blocks],
            tok_emb_q8=(None if dec.tok_emb_q8 is None
                        else _leaf(dec.tok_emb_q8, ds["tok_emb"], mesh, r, dev)))
        shards.append(Whisper(cfg, encoder, decoder))
    return ShardedWhisper(cfg, shards, mesh, vocab_split=vocab_split)

