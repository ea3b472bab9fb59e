"""The FFT that the log10-mel kernel (K7, ``csrc/log10_mel.cu``) runs on the
card, evaluated here in torch step by step as the kernel runs it, in the
kernel's precision and from the very table that ``ops/log10_mel.py:_tables``
hands the kernel: its power spectrum against the float64 spectrum and the
dense windowed-DFT bank's product, and its log10 mel against the JAX
package's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import HOP_LENGTH, N_FFT
from whisper_tpu.ops.mel_pallas import log10_mel_pallas
from whisper_tpu_torch.ops import log10_mel as lm
from whisper_tpu_torch.ops.mel import _dft_bank, _frame, mel_filterbank

torch.set_num_threads(2)

K7_TOL = 5e-4  # the JAX package's golden tolerance for its fused mel kernel
# the kernel's spectrum is float64 throughout: within float64 rounding of
# the exact one (1e-12 of the frame's largest power leaves a wide margin);
# the dense fp32 bank's product errs by ~1e-6 of it (1.3e-6 measured on
# noise), so the two agree within 1e-5
EXACT_RTOL = 1e-12
POWER_RTOL = 1e-5


def _c(t: torch.Tensor, off: int, j: int):
    return t[off + 2 * j], t[off + 2 * j + 1]


def _add(a, b):
    return a[0] + b[0], a[1] + b[1]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _mul_mi(a):  # a * (-i)
    return a[1], -a[0]


def _dft5(x, c1, s1, c2, s2):
    t1, t2, t3, t4 = _add(x[1], x[4]), _add(x[2], x[3]), _sub(x[1], x[4]), _sub(x[2], x[3])
    a = (x[0][0] + c1 * t1[0] + c2 * t2[0], x[0][1] + c1 * t1[1] + c2 * t2[1])
    b = (x[0][0] + c2 * t1[0] + c1 * t2[0], x[0][1] + c2 * t1[1] + c1 * t2[1])
    u = _mul_mi((s1 * t3[0] + s2 * t4[0], s1 * t3[1] + s2 * t4[1]))
    v = _mul_mi((s2 * t3[0] - s1 * t4[0], s2 * t3[1] - s1 * t4[1]))
    return [_add(x[0], _add(t1, t2)), _add(a, u), _add(b, v), _sub(b, v), _sub(a, u)]


def _dft4(x):
    c0, c1, c2 = _add(x[0], x[2]), _sub(x[0], x[2]), _add(x[1], x[3])
    c3 = _mul_mi(_sub(x[1], x[3]))
    return [_add(c0, c2), _add(c1, c3), _sub(c0, c2), _sub(c1, c3)]


def fft_power(frames: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 over 201 bins of (N, 400) fp32 frames, Hann-windowed, in the
    table's precision, by the kernel's steps: z[m] = x[2m] w[2m] + i x[2m+1]
    w[2m+1]; the 8-point DFTs over z[25 m1 + m2] twiddled by W_200^(m2 k1);
    the 25-point DFTs of each row k1 as 5 x 5 with W_25^(b c) between, into
    Z[k1 + 8 k2]; the real spectrum's bins k and 200 - k from Z[k] and
    Z[200 - k] with W_400^k."""
    t = table
    xw = frames.to(t.dtype) * t[lm.HANN:lm.HANN + N_FFT]
    z = [(xw[:, 2 * m], xw[:, 2 * m + 1]) for m in range(200)]
    c1, s1, c2, s2, r2 = (t[lm.CONST + i] for i in range(5))
    rows = [[None] * 25 for _ in range(8)]
    for m2 in range(25):
        v = [z[25 * m1 + m2] for m1 in range(8)]
        e = [_add(v[j], v[j + 4]) for j in range(4)]
        o = [_sub(v[j], v[j + 4]) for j in range(4)]
        o[1] = (r2 * (o[1][0] + o[1][1]), r2 * (o[1][1] - o[1][0]))
        o[2] = _mul_mi(o[2])
        o[3] = (r2 * (o[3][1] - o[3][0]), -r2 * (o[3][0] + o[3][1]))
        for q, (ev, od) in enumerate(zip(_dft4(e), _dft4(o))):
            rows[2 * q][m2] = _mul(ev, _c(t, lm.TW200, m2 * 8 + 2 * q))
            rows[2 * q + 1][m2] = _mul(od, _c(t, lm.TW200, m2 * 8 + 2 * q + 1))
    Z = [None] * 200
    for k1 in range(8):
        y = rows[k1]
        u = [[None] * 5 for _ in range(5)]
        for b in range(5):
            for c, val in enumerate(_dft5([y[5 * a + b] for a in range(5)], c1, s1, c2, s2)):
                u[b][c] = _mul(val, _c(t, lm.TW25, b * 5 + c))
        for c in range(5):
            for d, val in enumerate(_dft5([u[b][c] for b in range(5)], c1, s1, c2, s2)):
                Z[k1 + 8 * (c + 5 * d)] = val
    power = [None] * 201
    for k in range(101):
        A, B = Z[k], Z[(200 - k) % 200]
        E = (0.5 * (A[0] + B[0]), 0.5 * (A[1] - B[1]))
        O = _mul_mi((0.5 * (A[0] - B[0]), 0.5 * (A[1] + B[1])))
        WO = _mul(O, _c(t, lm.TW400, k))
        P, M = _add(E, WO), _sub(E, WO)
        power[k] = P[0] * P[0] + P[1] * P[1]
        if k != 100:
            power[200 - k] = M[0] * M[0] + M[1] * M[1]
    return torch.stack(power, dim=-1)


def _signals(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return {"noise": rng.standard_normal(n) * 0.2, "tone": 0.3 * np.sin(2 * np.pi * 440 * t),
            "impulses": (np.arange(n) % 397 == 0) * 0.8, "silence": np.zeros(n)}


def _padded(x: np.ndarray) -> np.ndarray:
    return np.pad(x[None], ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect").astype(np.float32)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_the_packed_filterbank_is_the_dense_one(n_mels):
    """_tables packs each filter's span [lo, lo + start[m+1] - start[m]):
    unpacked, it is the dense filterbank, and it holds every nonzero."""
    _, weights, lo, start = lm._tables(n_mels, torch.device("cpu"))
    fb = mel_filterbank(n_mels, N_FFT)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        n = int(start[m + 1] - start[m])
        dense[m, int(lo[m]):int(lo[m]) + n] = weights[int(start[m]):int(start[m + 1])].numpy()
    np.testing.assert_array_equal(dense, fb)
    assert int(start[-1]) == weights.numel() and start.dtype == lo.dtype == torch.int32


def test_the_kernel_table_is_fft_table():
    """_tables hands the kernel fft_table in the kernel's precision (float64);
    each entry is its float64 value, in the layout the kernel's offsets
    name."""
    table = lm._tables(80, torch.device("cpu"))[0]
    assert table.dtype == torch.float64 and table.shape == (lm.TABLE_FLOATS,)
    assert torch.equal(table, torch.from_numpy(lm.fft_table()))
    n = np.arange(N_FFT)
    np.testing.assert_array_equal(table[lm.HANN:lm.HANN + N_FFT].numpy(),
                                  0.5 * (1 - np.cos(2 * np.pi * n / N_FFT)))
    w = np.exp(-2j * np.pi * np.arange(101) / 400)
    np.testing.assert_array_equal(table[lm.TW400:lm.TW400 + 202:2].numpy(), w.real)
    np.testing.assert_array_equal(table[lm.TW400 + 1:lm.TW400 + 202:2].numpy(), w.imag)
    m2, k1 = 7, 5
    assert float(table[lm.TW200 + 2 * (m2 * 8 + k1)]) == np.cos(2 * np.pi * 35 / 200)
    assert float(table[lm.CONST + 4]) == np.sqrt(0.5)


@pytest.mark.parametrize("signal", ["noise", "tone", "impulses", "silence"])
def test_fft_power_matches_the_dense_bank(signal):
    """The kernel's FFT of 101 frames against the float64 spectrum (to
    EXACT_RTOL) and the plain version's frames @ windowed DFT bank (to its
    fp32 rounding, POWER_RTOL), bin by bin; silence gives exact zeros."""
    n_frames = 101
    x = torch.from_numpy(_padded(_signals(160 * (n_frames - 1), 3)[signal]))
    frames = _frame(x, n_frames, N_FFT, HOP_LENGTH)[0]
    table = lm._tables(80, torch.device("cpu"))[0]
    got = fft_power(frames, table)
    hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(N_FFT) / N_FFT))
    exact = np.abs(np.fft.rfft(frames.double().numpy() * hann, axis=-1)) ** 2
    spec = frames @ torch.from_numpy(_dft_bank(N_FFT))
    want = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    assert got.shape == want.shape == (n_frames, 201)
    if signal == "silence":
        assert float(got.abs().max()) == 0.0
        return
    scale = torch.from_numpy(exact).amax(dim=1, keepdim=True)
    assert float(((got - torch.from_numpy(exact)).abs() / scale).max()) <= EXACT_RTOL
    assert float(((got - want).abs() / scale).max()) <= POWER_RTOL


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("signal", ["noise", "tone", "silence"])
def test_fft_log10_mel_matches_pallas(n_mels, signal):
    """The kernel's FFT, the mel projection over each filter's [lo, hi) bins
    and log10, against log10_mel_pallas in interpret mode within K7_TOL;
    silence gives exactly -10."""
    n_frames = 101
    xp = _padded(_signals(160 * (n_frames - 1), n_mels)[signal])
    table, weights, lo, start = lm._tables(n_mels, torch.device("cpu"))
    power = fft_power(_frame(torch.from_numpy(xp), n_frames, N_FFT, HOP_LENGTH)[0], table)
    power = power.float()  # the kernel's power tile and mel stage are fp32
    mel = torch.zeros((n_mels, n_frames))
    for m in range(n_mels):  # the kernel's mel stage: each filter's packed span
        for j in range(int(start[m]), int(start[m + 1])):
            mel[m] = mel[m] + weights[j] * power[:, int(lo[m]) + j - int(start[m])]
    got = torch.log10(torch.clamp(mel, min=1e-10)).numpy()
    pallas = np.asarray(log10_mel_pallas(jnp.asarray(xp), n_mels=n_mels, n_frames=n_frames,
                                         interpret=True))[0]
    np.testing.assert_allclose(got, pallas, rtol=0, atol=K7_TOL)
    if signal == "silence":
        assert (got == np.float32(-10.0)).all()
