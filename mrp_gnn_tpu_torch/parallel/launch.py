"""Multi-process bring-up on ``torch.distributed`` (port of
``mrp_gnn_tpu/parallel/launch.py``).

One process is one rank, one position of the ("data", "graph") mesh. Each
process calls :func:`initialize` with the address of rank 0, the number of
processes and its own rank before it touches the mesh:

    python -m mrp_gnn_tpu_torch.train --config swarm_partitioned \\
        --coordinator localhost:29500 --num_processes 8 --process_id $ID \\
        --dist_backend gloo

The backend is the caller's choice and is never switched behind its back:

- ``nccl`` keeps every collective on the cards and needs one card per rank
  (more ranks on a host than cards are refused before
  ``init_process_group`` where the host's rank count is known); it has not
  yet run on more than one card;
- ``gloo`` runs the collectives through host memory: the exchange copies
  its rows of a CUDA tensor to a pinned host buffer, waits for the copy,
  sends, and copies what it received back on the rank's stream. Several
  ranks may share one card this way.

A rank's device is ``cuda:(local_rank % device_count)`` (:func:`rank_device`)
unless the caller names one (the CPU tests pass ``cpu``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_LOOPBACK = ("localhost", "127.0.0.1", "[::1]")


def _ranks_on_this_host(coordinator: str, num_processes: int) -> int | None:
    """The ranks that share this host's cards: ``LOCAL_WORLD_SIZE`` when the
    launcher sets it; all of them when the coordinator is this host's
    loopback address, which no other host can reach; else not known."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    host = coordinator.split("://")[-1].rsplit(":", 1)[0]
    return num_processes if host in _LOOPBACK else None


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl",
               timeout_s: float = 600.0) -> None:
    """``torch.distributed.init_process_group`` for this process; nothing
    when ``coordinator`` is None.

    coordinator: ``host:port`` of rank 0's store (``tcp://`` is added), or
    a whole init URL (``tcp://...``, ``file://...``). Raises ValueError for
    an unknown backend and for ``nccl`` with more ranks on this host than
    cards, where that count is known (``LOCAL_WORLD_SIZE``, or every rank
    when the coordinator is a loopback address). The NCCL transport has not
    yet run on more than one card.
    """
    if coordinator is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    if backend == "nccl":
        local = _ranks_on_this_host(coordinator, num_processes)
        cards = torch.cuda.device_count()
        if local is not None and local > cards:
            raise ValueError(
                f"nccl needs one CUDA card per rank: {local} rank(s) on this "
                f"host, {cards} card(s). Pass backend 'gloo' (--dist_backend "
                "gloo) to share a card through host memory")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """This process's rank among the ranks of its host (``LOCAL_RANK``,
    else its global rank)."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` when given, else
    ``cuda:(local_rank % device_count)`` (set as the current device). With
    no card it raises, as the entry points do: the CPU is only ever the
    caller's explicit choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev
