"""The multi-process bootstrap of the frame-sharded path.

Counterpart of wass_tpu/parallel/runner.py's initialize_multihost.  The
JAX package's sharded dense runner has no class here: the stereo loop
(cli/pipeline.py) runs each frame slot's frames through the same
DenseStereoPipeline as one slot's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: str = "nccl") -> bool:
    """torch.distributed bootstrap (jax.distributed.initialize's place);
    a no-op without a coordinator.  coordinator: "host:port" (a TCP store
    on the rank-0 host) or an init_method URL ("env://" under torchrun,
    which sets the world size and ranks).  backend: "nccl" for CUDA slots,
    one card a rank; "gloo" when asked (several ranks on one card: NCCL
    refuses two ranks on one device).  A failed initialization raises;
    the backend is never switched.  Under NCCL each rank makes its card
    (LOCAL_RANK, else the rank modulo the card count) the current device."""
    if coordinator is None:
        return False
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kwargs = {} if init_method.startswith("env://") else {"world_size": num_processes, "rank": process_id}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id if process_id is not None else os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return True
