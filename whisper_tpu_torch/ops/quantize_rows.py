"""One-pass symmetric int8 row quantization (K8q), the W8A8 linear's
activation half.

``quantize_rows`` is the counterpart of the quantization that XLA fuses into
the JAX package's ``whisper_tpu/models/model.py:_linear_a8`` (lines 103-105;
no Pallas kernel): rows x (M, K) bf16 or fp32 -> int8 (M, K) and their fp32
scales (M, 1), ``sx = max(max|x|, 1e-8) / 127`` and ``clamp(round(x / sx),
-127, 127)``, or the int8 rows alone at a given ``sx``. On a CUDA tensor it
launches the hand-written Hopper kernel
``whisper_tpu_torch/csrc/quantize_rows.cu`` (see the note there); on a CPU
tensor it runs :func:`quantize_rows_plain`, whose bits the kernel equals.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

MAX_K = 8192  # the kernel holds a row in registers: 256 threads x 4 chunks of 8


def row_scale(amax: torch.Tensor) -> torch.Tensor:
    """The W8A8 row scale from a row's absolute maximum. A tensor divisor:
    CUDA turns division by a Python scalar into a product with its
    reciprocal, which can put the scale one ulp off the CPU's (and the JAX
    package's) quotient and flip an int8 activation."""
    amax = torch.clamp(amax, min=1e-8)
    return amax / amax.new_full((), 127.0)


def quantize_rows_plain(x: torch.Tensor, sx: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (int8 rows, fp32 row scales (..., 1)) of ``x``
    (..., K), at ``sx`` when given."""
    xf = x.to(torch.float32)
    if sx is None:
        sx = row_scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _kernel():
    fn = _build.load("quantize_rows").quantize_rows
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor, sx: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (M, K) -> (int8 (M, K), fp32 row scales (M, 1)); with ``sx`` (M, 1)
    the rows are quantized at it and it is returned as it is.

    CPU tensors take the plain version; CUDA tensors launch the kernel (bf16
    or fp32 ``x``, contiguous and 16-byte aligned, K % 16 == 0, K <= 8192;
    ``sx`` fp32 contiguous on the same device) or raise.
    """
    if x.device.type == "cpu":
        return quantize_rows_plain(x, sx)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows runs on cpu or cuda, not {x.device}")
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_rows takes (M, K) bf16 or fp32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    M, K = x.shape
    if K % 16 or not 0 < K <= MAX_K:
        raise ValueError(f"the CUDA kernel needs K % 16 == 0 and 0 < K <= {MAX_K}, got K={K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if sx is not None and (sx.shape != (M, 1) or sx.dtype != torch.float32
                           or sx.device != x.device or not sx.is_contiguous()):
        raise ValueError(f"sx must be ({M}, 1) fp32, contiguous, on {x.device}; got "
                         f"{tuple(sx.shape)} {sx.dtype} on {sx.device}")
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    out_sx = torch.empty((M, 1), dtype=torch.float32, device=x.device) if sx is None else sx
    if M == 0:
        return q, out_sx
    err = _build.launch(_kernel(), x.device, x.data_ptr(), q.data_ptr(), out_sx.data_ptr(),
                        None if sx is None else sx.data_ptr(), M, K,
                        int(x.dtype == torch.bfloat16))
    if err:
        raise RuntimeError(f"quantize_rows launch failed: cudaError {err}")
    _build.count(quantize_rows)
    return q, out_sx


quantize_rows.launches = 0  # kernel launches; only the CUDA branch counts
