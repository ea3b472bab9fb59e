"""Tensor parallelism of the PyTorch port across distinct NVIDIA cards.

    python3 chip_tp.py

Needs two or more cards (four for the tp 4 phases). Builds the port's CUDA
kernels, then for N = 2 and 4 (where the host has N cards):

- ``tp_reference``: a small fp32 engine (base: 8 heads, so 4 or 2 on each
  rank, kvq + skvq) on a (1, N) mesh of N distinct cards against the
  one-rank engine on the CPU: equal texts;
- ``tp``: the turbo server built from ``--tp N`` (the server's defaults,
  the temperature ladder off), 8 clips over HTTP with exact launch counts
  on every rank, its W8A8 encoder bit-equal to a one-card engine's, and its
  texts beside that engine's (``chip_smoke.tensor_parallel``).

``chip_smoke.py`` runs the same phases with the ranks sharing one card.
Prints JSON lines, each card's ``nvidia-smi`` name and power limit, and as
the last line ``{"ok": true, "device": {...}}``; any failure exits non-zero
without it.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

import chip_smoke as cs


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_tp: needs two or more CUDA cards, found {n}", file=sys.stderr)
        return 1
    from whisper_tpu_torch.ops import _build
    from whisper_tpu_torch.ops.decode_attention import (
        cross_attention_decode, cross_attention_decode_dense, cross_attention_decode_fd,
        self_attention_decode, self_attention_decode_int8)
    from whisper_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_btd, flash_attention_btd_sharded)
    from whisper_tpu_torch.ops.int8_gemm import int8_gemm
    from whisper_tpu_torch.ops.log10_mel import log10_mel
    from whisper_tpu_torch.ops.quantize_rows import quantize_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cs.emit({"phase": "device", "nvidia_smi": smi.splitlines(), "cards": n,
             "torch": torch.__version__, "cuda": torch.version.cuda, **_build.build_all()})
    counters = (log10_mel, flash_attention_btd, int8_gemm, quantize_rows,
                cross_attention_decode_fd, self_attention_decode_int8, self_attention_decode,
                flash_attention, cross_attention_decode, cross_attention_decode_dense,
                flash_attention_btd_sharded)
    for tp in (2, 4):
        if tp > n:
            continue
        cs.emit(cs.tp_reference_check([f"cuda:{i}" for i in range(tp)], model="base"))
        cs.emit(cs.tensor_parallel(counters, flags=("--tp", str(tp)), phase=f"tp{tp}_cards"))
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": n}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
