"""Encoder self-attention: on the native (B, T, D) layout (K1) and split
into heads (K6).

``flash_attention_btd`` is the port of the TPU kernel
``whisper_tpu/ops/flash_attention.py:flash_attention_btd`` (``_btd_kernel``):
bidirectional full-softmax attention where head h is columns h*dh..(h+1)*dh
of q, k and v, with fp32 softmax and the output in v's dtype. On a CUDA
tensor it launches the hand-written Hopper kernel
``whisper_tpu_torch/csrc/flash_attention_btd.cu`` (see the note there on what
bounds it and how the design differs from the TPU's); on a CPU tensor it runs
:func:`flash_attention_btd_plain`, the same function in plain PyTorch.

``flash_attention`` is the port of the TPU kernel
``whisper_tpu/ops/flash_attention.py:flash_attention`` (``_attn_kernel``): the
same attention on split heads, q (B, H, Tq, dh) against k, v (B, H, Tk, dh),
Tq and Tk independent. On a CUDA tensor it launches
``whisper_tpu_torch/csrc/flash_attention.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`.

``flash_attention_btd_sharded`` is the port of the TPU entry
``whisper_tpu/ops/flash_attention.py:flash_attention_btd_sharded``: K1 under
a (data, model) mesh, one launch per rank on its local heads
(``flash_attention_btd_local``, which the tensor-parallel encoder calls on
its projections directly). It has no kernel of its own, as its TPU
counterpart runs ``flash_attention_btd``'s ``pallas_call`` inside
``shard_map``.

In bf16 both kernels are one TMA + wgmma kernel,
``whisper_tpu_torch/csrc/flash_attention_sm90.cuh``, launched on tensor maps
of each layout; TMA needs 16-byte aligned q, k and v.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build


def flash_attention_btd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              n_head: int) -> torch.Tensor:
    """Plain version: split heads, fp32 scores and softmax, weights cast to
    v's dtype before the product with V, heads merged back."""
    B, T, D = q.shape
    dh = D // n_head

    def split(x):
        return x.reshape(B, x.shape[1], n_head, dh).transpose(1, 2)

    scores = torch.matmul(split(q).to(torch.float32),
                          split(k).to(torch.float32).transpose(-1, -2))
    w = torch.softmax(scores * (dh ** -0.5), dim=-1).to(v.dtype)
    return torch.matmul(w, split(v)).transpose(1, 2).reshape(B, T, D)


def _check_launch(name: str, err: int) -> None:
    """Raise on a kernel entry's return: a cudaError_t (> 0) or minus the
    CUresult of a failed tensor-map encode (< 0)."""
    if err > 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    if err < 0:
        raise RuntimeError(f"{name}: encoding a TMA tensor map failed: CUresult {-err}")


_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p]


def _kernel(dtype: torch.dtype):
    lib = _build.load("flash_attention_btd")
    fn = lib.flash_attention_btd_bf16 if dtype == torch.bfloat16 else lib.flash_attention_btd_f32
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def flash_attention_btd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        n_head: int) -> torch.Tensor:
    """Attention over (B, T, D) q/k/v with ``n_head`` heads -> (B, T, D).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16 or fp32, dh = 64, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_btd_plain(q, k, v, n_head)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_btd runs on cpu or cuda, not {q.device}")
    B, T, D = q.shape
    if D % n_head or D // n_head != 64:
        raise ValueError(f"the CUDA kernel needs head dim 64, got D={D}, n_head={n_head}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share shape, dtype and device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, not {q.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("the CUDA kernel needs contiguous, 16-byte aligned (B, T, D) q, k, v")
    out = torch.empty_like(q)
    err = _build.launch(_kernel(q.dtype), q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), B, T, D, n_head, (D // n_head) ** -0.5)
    _check_launch("flash_attention_btd", err)
    _build.count(flash_attention_btd)
    return out


flash_attention_btd.launches = 0  # kernel launches; only the CUDA branch counts


# ------------------------------------------------- tensor parallel (K1 sharded)
def flash_attention_btd_local(qs, ks, vs, n_head: int, sharded: Optional[bool] = None) -> list:
    """K1 on each model shard's local projections: ``qs[r]``, ``ks[r]``,
    ``vs[r]`` are rank r's (B, T, D / tp) columns, its ``n_head // tp``
    heads, on its device; returns rank r's (B, T, D / tp) outputs. Attention
    is per head, so no collective is needed. With ``sharded`` (by default:
    more than one shard) every launch on the card also counts as one of
    ``flash_attention_btd_sharded``'s, as for one data row's block of a
    mesh; otherwise it is the unsharded K1."""
    tp = len(qs)
    if n_head % tp:
        raise ValueError(f"n_head={n_head} not divisible by TP={tp}")
    if sharded is None:
        sharded = tp > 1
    outs = []
    for q, k, v in zip(qs, ks, vs):
        outs.append(flash_attention_btd(q, k, v, n_head // tp))
        if sharded and q.device.type == "cuda":
            _build.count(flash_attention_btd_sharded)
    return outs


def flash_attention_btd_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                n_head: int, mesh) -> torch.Tensor:
    """Port of ``whisper_tpu/ops/flash_attention.py:flash_attention_btd_sharded``:
    K1 under a (data, model) mesh, with the JAX signature (full q, k, v).

    The batch splits over DATA where it divides (as the JAX entry's
    ``shard_map`` spec), the head-major D columns over MODEL; block (d, m)
    runs on ``mesh.devices[d, m]`` as :func:`flash_attention_btd_local`
    with ``n_head // tp`` heads, and the blocks are put back together on q's
    device. The column blocks are contiguous copies, since K1 refuses a
    strided view.

    The JAX entry falls back to XLA attention where the local head count
    does not tile its 128-column blocks (``btd_heads_ok``: turbo's 5 local
    heads at tp 4); K1 takes any head count of dh 64, so here every local
    head count runs the kernel. Both compute the same function."""
    from ..parallel.sharding import DATA_AXIS, MODEL_AXIS

    tp, n_data = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
    if n_head % tp:
        raise ValueError(f"n_head={n_head} not divisible by TP={tp}")
    B, _, D = q.shape
    rows = B // n_data if B % n_data == 0 else B
    width = D // tp
    out_rows = []
    for d in range(B // rows):
        devs = mesh.devices[d]
        blocks = [[t[d * rows:(d + 1) * rows, :, m * width:(m + 1) * width].contiguous().to(dev)
                   for m, dev in enumerate(devs)] for t in (q, k, v)]
        outs = flash_attention_btd_local(*blocks, n_head, sharded=mesh.devices.size > 1)
        out_rows.append(torch.cat([o.to(q.device) for o in outs], dim=-1))
    return torch.cat(out_rows, dim=0)


flash_attention_btd_sharded.launches = 0  # K1 launches under a mesh of tp > 1 shards


# ------------------------------------------------------------ split heads (K6)
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 scores and softmax, weights cast to v's dtype
    before the product with V; (B, H, Tq, dh) in v's dtype."""
    dh = q.shape[-1]
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    w = torch.softmax(scores * (dh ** -0.5), dim=-1).to(v.dtype)
    return torch.matmul(w, v)


_SPLIT_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p]


def _split_kernel(dtype: torch.dtype):
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bf16 if dtype == torch.bfloat16 else lib.flash_attention_f32
    fn.argtypes, fn.restype = _SPLIT_SIGNATURE, ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q (B, H, Tq, dh); k, v (B, H, Tk, dh) -> (B, H, Tq, dh) in v's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    dtype, bf16 or fp32, dh = 64, Tq and Tk >= 1, contiguous) or raise.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    B, H, Tq, dh = q.shape
    Tk = k.shape[2]
    if dh != 64:
        raise ValueError(f"the CUDA kernel needs head dim 64, got {dh}")
    if k.shape != (B, H, Tk, dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, H, Tk, dh) = ({B}, {H}, Tk, {dh}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if Tq < 1 or Tk < 1 or not 1 <= B * H <= 65535:
        raise ValueError(f"the CUDA kernel needs at least one query and one key and "
                         f"1 <= B*H <= 65535 (its grid's y), got Tq={Tq}, Tk={Tk}, B*H={B * H}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the CUDA kernel takes bf16 or fp32, not {q.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("the CUDA kernel needs contiguous, 16-byte aligned (B, H, T, dh) "
                         "q, k, v")
    out = torch.empty_like(q)
    err = _build.launch(_split_kernel(q.dtype), q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), B * H, Tq, Tk, dh ** -0.5)
    _check_launch("flash_attention", err)
    _build.count(flash_attention)
    return out


flash_attention.launches = 0  # kernel launches; only the CUDA branch counts
