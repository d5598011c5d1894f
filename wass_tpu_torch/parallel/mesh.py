"""Frame meshes: the global frame slots of a (multi-process) run.

Counterpart of wass_tpu/parallel/mesh.py.  The JAX package shards the
frame axis of every per-frame array over a 1-D ("frame",) device mesh.
Here a frame mesh is an ordered list of global frame slots, each a
(rank, torch.device) pair: a batch holds one frame per slot, and each
process dispatches the frames of its own slots, each on its slot's
device.  Under an initialized torch.distributed group every rank's local
devices are gathered rank-major (all_gather_object), so the slot order is
the same on every rank.

On the CPU a mesh of n slots on the one CPU device stands in for the JAX
package's n virtual CPU devices (tests/conftest.py); on one card, n slots
on `cuda:0` run the multi-slot code on that card.

`frame_sharding` and `replicated` (NamedShardings of a jax Mesh) have no
counterpart: a slot's tensors simply live on its device, and what the JAX
package replicates (camera parameters, the config) every slot holds or
receives as a copy.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from wass_tpu_torch.device import require_cuda


class Slot(NamedTuple):
    rank: int
    device: torch.device


def group_active() -> bool:
    """True inside an initialized torch.distributed process group."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if group_active() else 0


def world_size() -> int:
    return dist.get_world_size() if group_active() else 1


def default_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """This process's frame devices: every local card (the first n_devices),
    or, when it is one of several ranks, the card of its local rank
    (LOCAL_RANK, as torchrun sets it, else the rank modulo the card
    count)."""
    require_cuda()
    n = torch.cuda.device_count()
    if world_size() > 1:
        local = int(os.environ.get("LOCAL_RANK", rank() % n))
        return [torch.device("cuda", local)]
    return [torch.device("cuda", i) for i in range(n)][:n_devices]


def make_frame_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> List[Slot]:
    """The global frame slots: this process's `devices` (default_devices()
    when None; a device may repeat, one slot each), gathered rank-major
    across the process group when there is one."""
    local = [torch.device(d) for d in devices] if devices is not None else default_devices(n_devices)
    if not local:
        raise ValueError("a frame mesh needs at least one device")
    if world_size() == 1:
        return [Slot(0, d) for d in local]
    gathered: list = [None] * world_size()
    dist.all_gather_object(gathered, [str(d) for d in local])
    return [Slot(r, torch.device(d)) for r, devs in enumerate(gathered) for d in devs]


def local_frame_indices(mesh: Sequence[Slot]) -> List[int]:
    """The global slots this process owns, in mesh order (all of them in a
    single process)."""
    me = rank()
    return [k for k, s in enumerate(mesh) if s.rank == me]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the process group (t itself outside one).
    A gloo group reduces on the host: the tensor goes there and back."""
    if not group_active():
        return t
    if dist.get_backend() == "gloo" and t.device.type != "cpu":
        h = t.cpu()
        dist.all_reduce(h)
        return h.to(t.device)
    t = t.clone()
    dist.all_reduce(t)
    return t


def all_gather_host(obj) -> list:
    """obj of every rank, rank-major, gathered on the host ([obj] outside a
    process group)."""
    if not group_active():
        return [obj]
    out: list = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out
