"""Encoder self-attention on the native (B, T, D) layout.

``flash_attention_btd`` is the port of the TPU kernel
``whisper_tpu/ops/flash_attention.py:flash_attention_btd`` (``_btd_kernel``):
bidirectional full-softmax attention where head h is columns h*dh..(h+1)*dh
of q, k and v, with fp32 softmax and the output in v's dtype. On a CUDA
tensor it launches the hand-written Hopper kernel
``whisper_tpu_torch/csrc/flash_attention_btd.cu`` (see the note there on what
bounds it and how the design differs from the TPU's); on a CPU tensor it runs
:func:`flash_attention_btd_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

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
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous (B, T, D) q, k, v")
    out = torch.empty_like(q)
    err = _kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                           B, T, D, n_head, (D // n_head) ** -0.5, q.device.index or 0,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_btd launch failed: cudaError {err}")
    flash_attention_btd.launches += 1
    return out


flash_attention_btd.launches = 0  # kernel launches; only the CUDA branch counts
