"""LayerNorm to int8 rows (K8n): the W8A8 encoder's LayerNorm and the
activation quantization of the products that read it, in one pass.

:func:`layer_norm` is the port's fp32 LayerNorm island (the JAX package's
``whisper_tpu/models/model.py`` ``layer_norm``). Where its output feeds only
W8A8 products, the port needs no bf16 LayerNorm output, only its int8 rows
and row scales (:func:`~whisper_tpu_torch.ops.quantize_rows.quantize_rows`):
``layer_norm_rows(x, g, b)`` gives them from the rows of ``x`` in one launch
of the hand-written Hopper kernel ``whisper_tpu_torch/csrc/layer_norm_rows.cu``
(see the note there). On a CPU tensor it runs :func:`layer_norm_rows_plain`,
``layer_norm`` then ``quantize_rows_plain``; the kernel's rows differ from it
only where the order of the row sums moves a LayerNorm output by one ulp.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .quantize_rows import quantize_rows_plain

MAX_D = 8192  # K8q's limit; a row lives in registers, at most 256 threads x 5 chunks of 8
DTYPES = (torch.bfloat16, torch.float32)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm island (biased variance); returns x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * g.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def layer_norm_rows_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                          eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (int8 rows, fp32 row scales (..., 1)) of
    ``layer_norm(x, g, b)``."""
    return quantize_rows_plain(layer_norm(x, g, b, eps))


_SIGNATURE = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float]
              + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _kernel():
    fn = _build.load("layer_norm_rows").layer_norm_rows
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def layer_norm_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, D) -> (int8 (M, D), fp32 row scales (M, 1)) of
    ``layer_norm(x, g, b, eps)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16
    or fp32 ``x``, contiguous and 16-byte aligned, D % 16 == 0, D <= MAX_D;
    ``g`` and ``b`` (D,) of x's dtype, contiguous and 16-byte aligned, on the
    same device) or raise.
    """
    if x.device.type == "cpu":
        return layer_norm_rows_plain(x, g, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_rows runs on cpu or cuda, not {x.device}")
    if x.dim() != 2 or x.dtype not in DTYPES:
        raise ValueError(f"layer_norm_rows takes (M, D) bf16 or fp32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    M, D = x.shape
    if D % 16 or not 0 < D <= MAX_D:
        raise ValueError(f"the CUDA kernel needs D % 16 == 0 and 0 < D <= {MAX_D}, got D={D}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    for name, t in (("g", g), ("b", b)):
        if (t.shape != (D,) or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be ({D},) {x.dtype}, contiguous, 16-byte aligned, "
                             f"on {x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}")
    q = torch.empty((M, D), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0:
        return q, sx
    err = _build.launch(_kernel(), x.device, x.data_ptr(), g.data_ptr(), b.data_ptr(),
                        q.data_ptr(), sx.data_ptr(), M, D, eps, int(x.dtype == torch.bfloat16))
    if err:
        raise RuntimeError(f"layer_norm_rows launch failed: cudaError {err}")
    _build.count(layer_norm_rows)
    return q, sx


layer_norm_rows.launches = 0  # kernel launches; only the CUDA branch counts
