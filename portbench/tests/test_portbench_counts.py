"""The yardstick's operation and byte counts at turbo's shapes, against
numbers worked by hand."""

import json
import os

import pytest

from portbench import roofline
from portbench.tests.tiny import ROOT
from portbench.weights import Dims

TURBO = Dims.from_config(json.load(open(os.path.join(ROOT, "portbench/configs/turbo.json"))))


def test_k1_bound_at_b64():
    # 4 x 64 x 20 x 1500^2 x 64 flops at 989 TFLOP/s
    assert roofline.k1_seconds(TURBO, 64) * 1e3 == pytest.approx(0.7455, abs=5e-5)


def test_k8_bound_per_launch_at_m96000():
    # a layer's six products at M = 64 x 1500: 4 of 1280 x 1280, 1280 x 5120,
    # 5120 x 1280; bound by operations at 1,979 TOP/s
    assert [s[0] for s in roofline.k8_shapes(TURBO, 64)] == [96000] * 6
    assert roofline.k8_layer_seconds(TURBO, 64) / 6 * 1e3 == pytest.approx(0.318, abs=5e-4)


def test_k2_bound_at_b64():
    # 2 x 1280 x 64 x 1500 int8 bytes (+ scales, q, out) at 3.35 TB/s
    assert roofline.k2_seconds(TURBO, 64) * 1e3 == pytest.approx(0.0737, abs=5e-5)


def test_offline_step_by_hand():
    # the encoder's int8 products: 32 x 2 x 96000 x (4 x 1280^2 + 2 x 1280 x 5120)
    int8 = 32 * 2 * 96000 * (4 * 1280 ** 2 + 2 * 1280 * 5120)
    # bf16: stem, attention, cross-KV, 64 rows x (4 prompt + 63 fed) positions
    stem = 2 * 64 * 3000 * 3 * 128 * 1280 + 2 * 64 * 1500 * 3 * 1280 * 1280
    attn = 32 * 4 * 64 * 1500 * 1500 * 1280
    cross = 4 * 4 * 64 * 1500 * 1280 * 1280
    fed = 64 * 67
    keys = 64 * sum(range(1, 68))
    dec = 4 * (2 * fed * (6 * 1280 ** 2 + 2 * 1280 * 5120) + 4 * 1280 * (keys + fed * 1500))
    logits = 2 * 64 * 64 * 1280 * 51866
    want = int8 / 1979e12 + (stem + attn + cross + dec + logits) / 989e12
    got = roofline.offline_step_seconds(TURBO, 64, 4, [64] * 64)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.085 < got < 0.095  # about 90 ms: 10% of PR 18's 0.81 s batch
