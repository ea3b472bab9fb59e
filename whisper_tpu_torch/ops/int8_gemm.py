"""Int8 x int8 GEMM (K8), the product under every W8A8 projection.

``int8_gemm`` is the port of the TPU kernel
``benchmarks/int8_gemm_probe.py:make_pallas_gemm``: (M, K) int8 @ (K, N)
int8 -> (M, N) int32. ``int8_gemm_scaled`` runs the same kernel with the W8A8
linear's epilogue fused in (:func:`scale_epilogue`: row scale x channel
scale, the output dtype, the bias), which XLA fuses around the JAX
package's dot (``whisper_tpu/models/model.py:_linear_a8``). On a CUDA tensor
both launch the hand-written Hopper kernel
``whisper_tpu_torch/csrc/int8_gemm.cu`` (see the note there), which reads B
K-major: ``b`` must then be stored column-major, the transpose of a
contiguous (N, K), as :meth:`~whisper_tpu_torch.ops.quant.QTensor.k_major`
lays a weight out once. On a CPU tensor they run their plain versions.
Both count their launches on ``int8_gemm.launches``: one kernel, one count.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_OUT_MODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}  # the kernel's epilogues


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: an exact int32 matmul on the CPU. CUDA has no int32
    matmul, so there it runs in float64, which is exact here: |sum| <=
    K * 127^2 < 2^53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def scale_epilogue(acc: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                   bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """int32 product -> (row scale ``sx`` x channel scale ``ws``) in fp32 ->
    ``dtype``, + ``bias`` in ``dtype``: the JAX ``_linear_a8``'s epilogue."""
    y = ((acc.to(torch.float32) * sx) * ws.to(torch.float32).reshape(-1)).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_gemm_scaled_plain(a: torch.Tensor, b: torch.Tensor, sx: torch.Tensor,
                           ws: torch.Tensor, bias: Optional[torch.Tensor],
                           out_dtype) -> torch.Tensor:
    """Plain version of :func:`int8_gemm_scaled`."""
    return scale_epilogue(int8_gemm_plain(a, b), sx, ws, bias, out_dtype)


_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel():
    fn = _build.load("int8_gemm").int8_gemm_sm90a
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"{name} takes int8 operands, got {a.dtype}, {b.dtype}")
    K, N = b.shape
    if K % 16 or N % 8:
        raise ValueError(f"the CUDA kernel needs K % 16 == 0 and N % 8 == 0, got K={K}, N={N}")
    if b.device != a.device or not (a.is_contiguous() and b.t().is_contiguous()):
        raise ValueError("a must be contiguous and b column-major (QTensor.k_major), "
                         "on one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the TMA loads need 16-byte aligned operands")


def _launch(a, b, out, sx=None, ws=None, bias=None) -> torch.Tensor:
    M, K = a.shape
    if M == 0:
        return out
    err = _build.launch(_kernel(), a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                        *(None if t is None else t.data_ptr() for t in (sx, ws, bias)),
                        M, b.shape[1], K, _OUT_MODE[out.dtype])
    if err:
        raise RuntimeError(f"int8_gemm launch failed: error {err} (a cudaError_t, or "
                           f"minus a CUresult of the tensor-map encode)")
    _build.count(int8_gemm)
    return out


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (K % 16 == 0, N % 8 == 0, ``a`` contiguous, ``b`` column-major, both
    16-byte aligned) or raise.
    """
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b)
    _check(a, b, "int8_gemm")
    return _launch(a, b, torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32,
                                     device=a.device))


def int8_gemm_scaled(a: torch.Tensor, b: torch.Tensor, sx: torch.Tensor, ws: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16
                     ) -> torch.Tensor:
    """:func:`scale_epilogue` of ``a @ b``: a (M, K) int8, b (K, N) int8, row
    scales ``sx`` (M, 1) fp32, channel scales ``ws`` (N elements, fp32),
    ``bias`` (N,) or None -> (M, N) ``out_dtype`` (bf16 or fp32), only the
    output written.

    CPU tensors take the plain version; CUDA tensors launch the kernel (as
    :func:`int8_gemm` takes ``a`` and ``b``; ``sx`` and ``ws`` fp32,
    contiguous, 8-byte aligned; the bias cast to ``out_dtype`` as the plain
    version casts it) or raise.
    """
    if a.device.type == "cpu":
        return int8_gemm_scaled_plain(a, b, sx, ws, bias, out_dtype)
    _check(a, b, "int8_gemm_scaled")
    M, N = a.shape[0], b.shape[1]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_gemm_scaled writes bf16 or fp32, not {out_dtype}")
    if bias is not None:
        bias = bias.to(out_dtype)
    for name, t, numel in (("sx", sx, M), ("ws", ws, N), ("bias", bias, N)):
        if t is None and name == "bias":
            continue
        if (t.numel() != numel or t.device != a.device or not t.is_contiguous()
                or t.data_ptr() % 8 or (name != "bias" and t.dtype != torch.float32)):
            raise ValueError(f"{name} must hold {numel} contiguous, 8-byte aligned values on "
                             f"{a.device} (fp32 for the scales); got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return _launch(a, b, torch.empty((M, N), dtype=out_dtype, device=a.device), sx, ws, bias)


int8_gemm.launches = 0  # kernel launches of both entries; only the CUDA branch counts
