"""Multi-process runtime over ``torch.distributed``, the counterpart of
``rebel_tpu/parallel/distributed.py``.

The JAX package runs one SPMD program over every device of every process
(``jax.distributed.initialize``).  The port runs one process per rank,
each driving one device, and joins them in one process group:

* :func:`initialize` calls ``torch.distributed.init_process_group`` with a
  ``tcp://`` init method.  Given no arguments it reads ``torchrun``'s
  variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
  or Slurm's (``SLURM_PROCID``, ``SLURM_NTASKS``, ``SLURM_JOB_NODELIST``),
  and with one process it does nothing.
* A rank's device is ``cuda:{local_rank % torch.cuda.device_count()}``,
  or the CPU when the caller asks for it.
* The backend follows one fixed rule (:func:`backend_for`): ``nccl`` when
  every rank of the host has a card of its own, ``gloo`` when ranks share
  a card or run on the CPU.  It is logged and never switched after a
  failure.

The collectives (:func:`all_reduce_`, :func:`all_gather`,
:func:`broadcast_`) take tensors anywhere: over gloo they travel through
host copies, over NCCL through the rank's card.  Without a process group
they are the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
from typing import NamedTuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_PORT = 29500
# A rank that waits longer than this in a collective fails (a peer died).
TIMEOUT = datetime.timedelta(minutes=30)


class Runtime(NamedTuple):
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str | None  # None: one process, no group


def backend_for(device: torch.device, local_world: int) -> str:
    """``nccl`` when each of the host's ``local_world`` ranks has a card of
    its own, else ``gloo`` (ranks that share a card, or the CPU)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(local_rank: int | None, device="cuda") -> torch.device:
    """The device of the host's ``local_rank``-th rank: a card chosen
    round-robin, or the CPU; ``device`` itself for a process alone
    (``local_rank=None``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    if local_rank is None:
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _first_host(nodelist: str) -> str:
    """The first host of a Slurm node list (``n1,n2`` or ``n[03-05,7]``)."""
    m = re.match(r"([^,\[]+)(?:\[(\d+))?", nodelist)
    if m is None:
        raise ValueError(f"cannot read a host from {nodelist!r}")
    return m.group(1) + (m.group(2) or "")


def detect_env(env=None) -> dict | None:
    """``coordinator``, ``num_processes``, ``process_id``, ``local_rank``,
    ``local_world`` from ``torchrun``'s or Slurm's variables; ``None``
    where neither launched this process."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return dict(
            coordinator=(f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                         f"{env.get('MASTER_PORT', DEFAULT_PORT)}"),
            num_processes=world, process_id=int(env["RANK"]),
            local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
            local_world=int(env.get("LOCAL_WORLD_SIZE", world)))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        world = int(env["SLURM_NTASKS"])
        host = env.get("MASTER_ADDR") or _first_host(
            env.get("SLURM_JOB_NODELIST", "127.0.0.1"))
        per_node = env.get("SLURM_NTASKS_PER_NODE", str(world))
        return dict(
            coordinator=f"{host}:{env.get('MASTER_PORT', DEFAULT_PORT)}",
            num_processes=world, process_id=int(env["SLURM_PROCID"]),
            local_rank=int(env.get("SLURM_LOCALID", 0)),
            local_world=int(re.match(r"\d+", per_node).group()))
    return None


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               local_rank: int | None = None,
               local_world: int | None = None) -> Runtime:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator`` (``host:port``).  Ranks launched on one host
    (the launcher's) have ``local_rank = process_id``.  With no arguments
    the cluster's variables are read (:func:`detect_env`); with one process
    no group is made."""
    if coordinator is None and num_processes is None:
        found = detect_env()
        if found is None:
            log.info("no cluster environment found; one process")
            return Runtime(0, 1, 0, rank_device(None, device), None)
        coordinator, num_processes, process_id = (
            found["coordinator"], found["num_processes"],
            found["process_id"])
        local_rank, local_world = found["local_rank"], found["local_world"]
    if num_processes == 1:
        log.info("one process; no process group")
        return Runtime(0, 1, 0, rank_device(None, device), None)
    local_rank = process_id if local_rank is None else local_rank
    local_world = num_processes if local_world is None else local_world
    dev = rank_device(local_rank, device)
    backend = backend_for(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("process group: rank %d of %d on %s, backend %s (%s)",
             process_id, num_processes, dev, backend,
             "a card per rank" if backend == "nccl" else
             "ranks share a card" if dev.type == "cuda" else "CPU ranks")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return Runtime(process_id, num_processes, local_rank, dev, backend)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ----------------------------------------------------------- collectives
def _wire(group) -> torch.device:
    """Where a collective's tensors must lie: the host for gloo, this
    rank's card for NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (every member gets the same
    bits)."""
    if not dist.is_initialized():
        return t
    wire = t.to(_wire(group)).contiguous()
    dist.all_reduce(wire, group=group)
    return t if wire is t else t.copy_(wire)


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """``t`` of every member of ``group`` concatenated along ``dim`` in
    rank order (JAX's ``all_gather(..., tiled=True)``)."""
    if not dist.is_initialized():
        return t
    src = t.to(_wire(group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s in place."""
    if not dist.is_initialized():
        return t
    wire = t.to(_wire(group)).contiguous()
    dist.broadcast(wire, src, group=group)
    return t if wire is t else t.copy_(wire)


# The group of a one-rank axis: its collectives are the identity.
SOLO = "solo"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a rank layout (the port's mesh axis): the process group
    of the ranks that differ only along it (``None``: the default group;
    :data:`SOLO`: this rank alone), its size and this rank's index on it."""

    group: object
    size: int
    index: int

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum`` over the axis, in place."""
        return t if self.group is SOLO else all_reduce_(t, self.group)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``jax.lax.all_gather(..., tiled=True)`` over the axis."""
        return t if self.group is SOLO else all_gather(t, self.group, dim)
