"""Multi-host runtime initialization.

Port of ``whisper_tpu/parallel/distributed.py``. Serving is data-parallel
across hosts: each host feeds its local cards utterance batches, and the only
traffic between hosts is request routing, never the token loop. One host
needs no set-up at all.

    from whisper_tpu_torch.parallel import distributed
    distributed.initialize()             # torch.distributed when several processes
    mesh = distributed.serving_mesh(tp=1)
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .sharding import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize ``torch.distributed`` (a no-op for one process).

    The arguments fall back to the environment ``torchrun`` sets
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); nothing on
    a host tells a program of its cluster otherwise. NCCL between cards,
    gloo without them."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return  # single host
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    torch.distributed.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def serving_mesh(tp: int = 1):
    """(data, model) mesh over this host's CUDA cards, ``tp`` cards per model
    shard group."""
    n = torch.cuda.device_count()
    if n == 0 or n % tp:
        raise ValueError(f"{n} CUDA cards not divisible by tp={tp}")
    return make_mesh(n // tp, tp)


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a globally-sharded utterance batch."""
    ready = torch.distributed.is_available() and torch.distributed.is_initialized()
    n_proc = torch.distributed.get_world_size() if ready else 1
    i = torch.distributed.get_rank() if ready else 0
    per = global_batch // n_proc
    return slice(i * per, (i + 1) * per)
