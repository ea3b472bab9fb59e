"""The int8 GEMM (K8) on the CPU: its plain version against the JAX
package's Pallas kernel ``benchmarks/int8_gemm_probe.py:make_pallas_gemm``
in interpret mode, exactly (int32)."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.ops.int8_gemm import int8_gemm, int8_gemm_plain
from whisper_tpu_torch.ops.quant import quantize_weight

PROBE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "int8_gemm_probe.py"


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("int8_gemm_probe", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("M,K,N,bm,bn", [(64, 128, 64, 32, 32), (96, 64, 128, 32, 64),
                                         (32, 256, 32, 32, 32)])
def test_int8_gemm_plain_equals_pallas(probe, monkeypatch, M, K, N, bm, bn):
    monkeypatch.setenv("WHISPER_TPU_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(M + K + N)
    a = rng.integers(-127, 128, (M, K), dtype=np.int8)
    b = rng.integers(-127, 128, (K, N), dtype=np.int8)
    want = np.asarray(probe.make_pallas_gemm(M, K, N, bm, bn)(jnp.asarray(a), jnp.asarray(b)))
    got = int8_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_gemm_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  want)


def test_int8_gemm_cpu_counts_no_launch():
    before = int8_gemm.launches
    a = torch.full((3, 16), -127, dtype=torch.int8)
    b = torch.full((16, 8), -127, dtype=torch.int8)
    assert (int8_gemm(a, b) == 16 * 127 * 127).all()
    assert int8_gemm.launches == before


def test_linear_a8_goes_through_int8_gemm(monkeypatch):
    """_linear_a8's int8 product is the K8 wrapper's, with the weight laid
    out K-major once, in place, and no copy of it kept beside."""
    calls = []

    def spy(a, b):
        calls.append((a.shape, b.shape, a.is_contiguous(), b.t().is_contiguous(), b.data_ptr()))
        return int8_gemm_plain(a, b)

    monkeypatch.setattr(tm, "int8_gemm", spy)
    w = quantize_weight(torch.randn(64, 48))
    row_major = w.q.clone()
    y = tm._linear_a8(torch.randn(2, 5, 64), w, None, torch.float32)
    assert y.shape == (2, 5, 48)
    assert calls == [((10, 64), (64, 48), True, True, w.q.data_ptr())]
    assert torch.equal(w.q, row_major) and w.q.t().is_contiguous()
    # batch 1 in the conv stem's transposed layout: flattening it is a
    # strided view, and the kernel is handed a contiguous copy; the weight
    # is not laid out again
    x = torch.randn(1, 64, 5).transpose(1, 2)
    assert not x.reshape(-1, 64).is_contiguous()
    tm._linear_a8(x, w, None, torch.float32)
    assert calls[-1] == ((5, 64), (64, 48), True, True, calls[0][-1])
    assert w.k_major() is w.q
