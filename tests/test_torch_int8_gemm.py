"""The int8 GEMM (K8) and the row quantization (K8q) on the CPU: K8's plain
version against the JAX package's Pallas kernel
``benchmarks/int8_gemm_probe.py:make_pallas_gemm`` in interpret mode,
exactly (int32); K8q's plain version and K8's scaled epilogue against the
JAX package's ``_linear_a8`` (``whisper_tpu/models/model.py:88-112``), bit for
bit."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.models import model as jm
from whisper_tpu.ops.quant import QTensor as JQTensor
from whisper_tpu_torch.models import model as tm
from whisper_tpu_torch.ops.int8_gemm import (int8_gemm, int8_gemm_plain, int8_gemm_scaled,
                                             int8_gemm_scaled_plain)
from whisper_tpu_torch.ops.quant import quantize_weight
from whisper_tpu_torch.ops.quantize_rows import quantize_rows, quantize_rows_plain

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
    """_linear_a8 is one K8q call on the flattened rows and one scaled K8
    call, with the weight laid out K-major once, in place, and no copy of
    it kept beside."""
    calls = []

    def spy_quantize(x, sx=None):
        calls.append(("quantize", x.shape, x.is_contiguous(), sx))
        return quantize_rows_plain(x, sx)

    def spy_gemm(a, b, sx, ws, bias, dtype):
        calls.append(("gemm", a.shape, b.shape, a.is_contiguous(), b.t().is_contiguous(),
                      b.data_ptr(), sx.shape, ws is w.s, bias, dtype))
        return int8_gemm_scaled_plain(a, b, sx, ws, bias, dtype)

    monkeypatch.setattr(tm, "quantize_rows", spy_quantize)
    monkeypatch.setattr(tm, "int8_gemm_scaled", spy_gemm)
    w = quantize_weight(torch.randn(64, 48))
    row_major = w.q.clone()
    y = tm._linear_a8(torch.randn(2, 5, 64), w, None, torch.float32)
    assert y.shape == (2, 5, 48)
    assert calls == [("quantize", (10, 64), True, None),
                     ("gemm", (10, 64), (64, 48), True, True, w.q.data_ptr(), (10, 1), True, None,
                      torch.float32)]
    assert torch.equal(w.q, row_major) and w.q.t().is_contiguous()
    # batch 1 in the conv stem's old transposed layout: flattening it is a
    # strided view, and the kernels are handed a contiguous copy; the weight
    # is not laid out again
    x = torch.randn(1, 64, 5).transpose(1, 2)
    assert not x.reshape(-1, 64).is_contiguous()
    tm._linear_a8(x, w, None, torch.float32)
    assert calls[-2][:3] == ("quantize", (5, 64), True)
    assert calls[-1][1:6] == ((5, 64), (64, 48), True, True, calls[1][5])
    assert w.k_major() is w.q


def _rows_with_ties(rng, K):
    """Seeded rows of width K: noise at several scales, an all-zero row, rows
    whose x / sx lands exactly on .5 (amax 127 gives sx = 1, amax 254 gives
    sx = 2), and a row below the 1e-8 floor of the scale."""
    x = rng.standard_normal((12, K)).astype(np.float32) * np.float32([[3.0]] * 6 + [[0.01]] * 6)
    x[3] = 0.0
    for r, (amax, ties) in ((4, (127.0, [0.5, -0.5, 1.5, 2.5, -3.5, 40.5])),
                            (5, (254.0, [1.0, 5.0, -7.0, 9.0, -81.0, 3.0]))):
        x[r] = np.resize(np.float32(ties), K)
        x[r, 0] = amax
    x[6] = np.float32(3e-9)
    x[6, 1] = -np.float32(1e-9)
    return x


def _jax_quantize(x: np.ndarray, dtype):
    """Lines 103-105 of the JAX package's ``_linear_a8`` on ``x`` in
    ``dtype``: (int8 rows, fp32 row scales)."""
    xf = jnp.asarray(x).astype(dtype).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    x8 = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    return np.asarray(x8), np.asarray(sx)


@pytest.mark.parametrize("K", [64, 1280])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_plain_equals_jax(dtype, K):
    """K8q's plain version (and so the kernel it is held to) gives the JAX
    quantization's bits for bf16 and fp32 rows, .5 ties rounded to even,
    zero rows and rows under the scale's floor included."""
    x = _rows_with_ties(np.random.default_rng(K), K)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want8, want_sx = _jax_quantize(x, getattr(jnp, dtype))
    before = quantize_rows.launches
    for got8, got_sx in (quantize_rows(xt), quantize_rows_plain(xt)):
        assert got8.dtype == torch.int8 and got_sx.dtype == torch.float32
        assert got_sx.shape == (12, 1)
        np.testing.assert_array_equal(got8.numpy(), want8)
        np.testing.assert_array_equal(got_sx.numpy().view(np.int32), want_sx.view(np.int32))
    assert quantize_rows.launches == before  # the CPU runs no kernel
    # the constructed ties are there and went to even
    np.testing.assert_array_equal(want8[4, 1:6], [0, 2, 2, -4, 40])  # -0.5 1.5 2.5 -3.5 40.5
    np.testing.assert_array_equal(want8[5, 1:6], [2, -4, 4, -40, 2])  # 2.5 -3.5 4.5 -40.5 1.5
    assert (want8[3] == 0).all() and want_sx[3, 0] == np.float32(1e-8) / np.float32(127.0)


def test_quantize_rows_at_a_given_scale():
    """The entry the tensor-parallel row-parallel products use: the rows at
    a given (global) scale, the scale handed back as it is."""
    x = _rows_with_ties(np.random.default_rng(5), 96)
    sx = torch.from_numpy(np.abs(x).max(-1, keepdims=True) * 2 / 127 + 1e-3)
    x8, got = quantize_rows(torch.from_numpy(x), sx)
    assert got is sx
    want = jnp.clip(jnp.round(jnp.asarray(x) / jnp.asarray(sx.numpy())), -127, 127)
    np.testing.assert_array_equal(x8.numpy(), np.asarray(want.astype(jnp.int8)))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_int8_gemm_scaled_equals_jax_linear_a8(in_dtype, bias):
    """K8q + K8's scaled epilogue (their plain versions: ``_linear_a8`` on the
    CPU, and the two entries called directly) equal the JAX ``_linear_a8``
    exactly in fp32, with and without a bias (``wk`` has none)."""
    rng = np.random.default_rng(17)
    x = _rows_with_ties(rng, 256)
    w = quantize_weight(torch.from_numpy(rng.standard_normal((256, 72)).astype(np.float32)))
    b = rng.standard_normal(72).astype(np.float32) if bias else None
    jx = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    want = np.asarray(jm._linear_a8(jx, JQTensor(jnp.asarray(w.q.numpy()), jnp.asarray(w.s.numpy())),
                                    None if b is None else jnp.asarray(b), jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, in_dtype))
    tb = None if b is None else torch.from_numpy(b)
    got = tm._linear_a8(xt, w, tb, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    x8, sx = quantize_rows(xt)
    direct = int8_gemm_scaled(x8, w.k_major(), sx, w.s, tb, torch.float32)
    np.testing.assert_array_equal(direct.numpy(), want)


def test_int8_gemm_scaled_bf16_rounds_before_and_after_the_bias():
    """bf16 out: the scaled product is rounded to bf16, the bf16 bias added
    in fp32 and the sum rounded again (``.to(bf16) + b.to(bf16)``), as the
    JAX ``_linear_a8`` computes it in bf16."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 128)).astype(np.float32)
    w = quantize_weight(torch.from_numpy(rng.standard_normal((128, 48)).astype(np.float32)))
    b = (rng.standard_normal(48) * 50).astype(np.float32)
    xb, bb = torch.from_numpy(x).bfloat16(), torch.from_numpy(b).bfloat16()
    x8, sx = quantize_rows(xb)
    got = int8_gemm_scaled(x8, w.k_major(), sx, w.s, bb, torch.bfloat16)
    acc = int8_gemm_plain(x8, w.q)
    once = ((acc.float() * sx) * w.s.reshape(-1)).bfloat16()
    assert torch.equal(got, (once.float() + bb.float()).bfloat16())
    assert not torch.equal(got, ((acc.float() * sx) * w.s.reshape(-1) + bb.float()).bfloat16())
    jw = JQTensor(jnp.asarray(w.q.numpy()), jnp.asarray(w.s.numpy()))
    want = jm._linear_a8(jnp.asarray(x).astype(jnp.bfloat16), jw, jnp.asarray(b).astype(
        jnp.bfloat16), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
