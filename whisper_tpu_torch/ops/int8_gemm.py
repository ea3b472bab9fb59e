"""Int8 x int8 -> int32 GEMM (K8), the product under every W8A8 projection.

``int8_gemm`` is the port of the TPU kernel
``benchmarks/int8_gemm_probe.py:make_pallas_gemm``: (M, K) int8 @ (K, N)
int8 -> (M, N) int32. On a CUDA tensor it launches the hand-written Hopper
kernel ``whisper_tpu_torch/csrc/int8_gemm.cu`` (see the note there), which
reads B K-major: ``b`` must then be stored column-major, the transpose of a
contiguous (N, K), as :meth:`~whisper_tpu_torch.ops.quant.QTensor.k_major`
lays a weight out once. On a CPU tensor it runs :func:`int8_gemm_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def int8_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: an exact int32 matmul on the CPU. CUDA has no int32
    matmul, so there it runs in float64, which is exact here: |sum| <=
    K * 127^2 < 2^53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


_SIGNATURE = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _kernel():
    fn = _build.load("int8_gemm").int8_gemm_kmajor
    fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
    return fn


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (K % 16 == 0, N % 8 == 0, ``a`` contiguous, ``b`` column-major, both
    16-byte aligned) or raise.
    """
    if a.device.type == "cpu":
        return int8_gemm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cpu or cuda, not {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_gemm takes (M, K) @ (K, N), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError(f"int8_gemm takes int8 operands, got {a.dtype}, {b.dtype}")
    if K % 16 or N % 8:
        raise ValueError(f"the CUDA kernel needs K % 16 == 0 and N % 8 == 0, got K={K}, N={N}")
    if b.device != a.device or not (a.is_contiguous() and b.t().is_contiguous()):
        raise ValueError("a must be contiguous and b column-major (QTensor.k_major), "
                         "on one device")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("the CUDA kernel loads 16 bytes at a time: pointers must be "
                         "16-byte aligned")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0:
        return out
    err = _build.launch(_kernel(), a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K)
    if err:
        raise RuntimeError(f"int8_gemm launch failed: cudaError {err}")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0  # kernel launches; only the CUDA branch counts
