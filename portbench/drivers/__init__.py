"""The entries a traffic mix's ``kind`` names: each builds the port's model
(``ctx.cell.family.port_model``), warms it, runs the measured window and
returns a ``harness.Outcome``. These and the families' ``port_model`` are
the only code here that imports the port."""

from __future__ import annotations

import torch

def build() -> dict:
    """Build the port's CUDA kernels that its build directory in the
    checkout lacks, all at once (the first run in a checkout builds, later
    runs find them built): how many were missing and the seconds taken."""
    from whisper_tpu_torch.ops import _build

    missing = [n for n in _build.KERNELS if not _build.library_path(n).exists()]
    return {"kernels_built": len(missing), **_build.build_all()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """Each hand-written kernel wrapper's launch count so far."""
    from whisper_tpu_torch.utils.graphs import kernel_wrappers

    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
