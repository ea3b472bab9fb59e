"""The kernel build cache: a library's path hashes its source, every header
under csrc/ and the flags, so an edited source or shared header rebuilds
instead of loading a stale library. Runs on the CPU: nothing is compiled."""

import shutil

import pytest

from whisper_tpu_torch.ops import _build

SHARED = "flash_attention_sm90.cuh"  # the bf16 kernel of K1 and K6


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the build module reads instead of the repo's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_kernels_include_the_shared_header():
    for name in ("flash_attention_btd", "flash_attention"):
        assert f'#include "{SHARED}"' in (_build.CSRC / f"{name}.cu").read_text()


@pytest.mark.parametrize("name", _build.KERNELS)
def test_editing_a_header_rebuilds(csrc, name):
    before = _build.library_path(name)
    assert _build.library_path(name) == before  # the same sources, the same path
    header = csrc / SHARED
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"{name}.") and after.suffix == ".so"


@pytest.mark.parametrize("name", _build.KERNELS)
def test_editing_a_source_rebuilds_only_its_library(csrc, name):
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    src = csrc / f"{name}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert [n for n in _build.KERNELS if after[n] != before[n]] == [name]


def test_a_new_header_rebuilds(csrc):
    before = _build.library_path("flash_attention_btd")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_attention_btd") != before


@pytest.mark.parametrize("name", ["cross_attention_decode", "self_attention_decode"])
def test_decode_kernels_include_their_common_header(name):
    """K2 and K3 share the int8 -> fp32 conversion and the warp reductions."""
    assert '#include "decode_common.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
