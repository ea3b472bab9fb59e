"""Build the port's CUDA kernels and load them with ctypes.

Each ``whisper_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own by ``nvcc`` for ``sm_90a`` into
``<repo>/build/whisper_tpu_torch/<name>.<hash>.so`` (``build/`` is ignored by
git), the hash covering the source and the flags, so an edited source
rebuilds. Nothing here runs at import: a kernel is built at its first use, or
all at once, in parallel, by :func:`build_all`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import IO, Dict, Iterable, NamedTuple, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "whisper_tpu_torch"
KERNELS = ("flash_attention_btd", "cross_attention_decode", "self_attention_decode",
           "int8_gemm", "log10_mel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed (CUDA_HOME or PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}.{digest}.so"


class _Build(NamedTuple):
    proc: subprocess.Popen
    out: Path
    tmp: Path
    log: IO[str]


def _start(name: str) -> Optional[_Build]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log.write(" ".join(cmd) + "\n")
    log.flush()
    return _Build(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), out, tmp, log)


def _finish(name: str, b: _Build) -> None:
    rc = b.proc.wait()
    b.log.close()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}); see {b.out.with_suffix('.log')}")
    os.replace(b.tmp, b.out)  # atomic: a concurrent build sees all or nothing


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Build every kernel with one nvcc per source, all started together.
    Returns the seconds until all were built."""
    t0 = time.perf_counter()
    with _lock:
        procs = {n: _start(n) for n in names}
        for n, p in procs.items():
            if p is not None:
                _finish(n, p)
    return {"build_s": time.perf_counter() - t0}


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill report) of the last build."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            proc = _start(name)
            if proc is not None:
                _finish(name, proc)
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
