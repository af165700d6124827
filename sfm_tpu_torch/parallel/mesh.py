"""The mesh and its sharding helpers (counterpart of
``sfm_tpu/parallel/mesh.py``).

The JAX package shards one program over a ``jax.sharding.Mesh`` of
devices.  Here every rank is a process with one device, and the mesh is
the default ``torch.distributed`` process group seen from one rank: its
rank, its size and the rank's ``torch.device``.  A replicated array is
the same tensor on every rank (``put_replicated``); a sharded array is
the rank's own contiguous block of rows (``put_sharded``,
``put_local_shards``), and ``gather_sharded`` assembles the blocks
again where the JAX package would read the global array.  ``psum``
becomes :meth:`Mesh.all_reduce`.

The mesh always owns a real process group, also at size 1 (an
in-process store: NCCL for a rank on a card, gloo on the CPU), so the
same collectives run at every size.  The group is process-global:
:meth:`Mesh.close`, or leaving a ``with`` block, destroys it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _rank_device(device) -> torch.device:
    """``device``, with a card index for a bare ``cuda``: the rank's
    ``LOCAL_RANK`` under a launcher, else card 0."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


class Mesh:
    """A 1-D mesh over every rank of the default process group."""

    axis = DATA_AXIS

    def __init__(self, device):
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = _rank_device(device)
        # gloo reduces host tensors: ranks that share one card over gloo
        # move what they exchange through host memory, explicitly.
        self._via_host = self.backend == "gloo" and self.device.type == "cuda"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, on every rank (a new tensor)."""
        y = x.cpu() if self._via_host else x.clone()
        dist.all_reduce(y)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in rank order (the
        same shape on every rank)."""
        src = x.cpu() if self._via_host else x.contiguous()
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src)
        return torch.stack(out).to(x.device)

    def close(self):
        """Destroy the process group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, backend={self.backend!r}, "
                f"device={self.device})")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None) -> int:
    """Join the processes of a multi-process run into the default group:
    from the arguments (``host:port`` of rank 0, the world size, this
    process's rank) or torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` names the
    rank's card).  ``backend``: ``nccl`` for ranks on cards of their own
    (the default where a card is present), ``gloo`` for CPU tensors or
    ranks that share a card.

    Call it once per process before any CUDA work.  Single-process with
    no such environment there is nothing to join: it returns 1, as the
    JAX package's does; already joined, it returns the world size.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed: needs rank 0's address, the number of "
                         "processes and this process's rank (or torchrun's "
                         "MASTER_ADDR, WORLD_SIZE and RANK)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_rank_device("cuda"))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """A mesh of ``n_devices`` ranks (None or <= 0: every device).

    Devices are the world's ranks where a group exists (one device
    each), else this machine's cards (``device`` on a card) or the CPU
    (one).  More than that raises ``ValueError`` naming both counts.  A
    single process forms a mesh of 1 with a group of its own; more ranks
    need one process each, launched by ``torchrun --nproc-per-node N``
    and joined by :func:`init_distributed`.
    """
    device = torch.device(device)
    if dist.is_initialized():
        have = dist.get_world_size()
    else:
        have = torch.cuda.device_count() if device.type == "cuda" else 1
    n = have if n_devices is None or n_devices <= 0 else n_devices
    if n > have or n < 1:
        raise ValueError(f"requested {max(n, 1)} devices, have {have}")
    if dist.is_initialized():
        if n != have:
            raise ValueError(f"a mesh of {n} in a world of {have} processes: the "
                             f"mesh spans the whole world")
        return Mesh(device)
    if n > 1:
        raise ValueError(f"a mesh of {n} devices takes one process per device: launch "
                         f"under torchrun --nproc-per-node {n} and join the processes "
                         f"with init_distributed (the CLI's --distributed)")
    device = _rank_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(device)


def make_global_mesh(device=None) -> Mesh:
    """A mesh over every rank of the joined world (:func:`init_distributed`),
    each on ``device`` (default: its card ``cuda:LOCAL_RANK`` under NCCL,
    the CPU under gloo).  Single-process: :func:`make_mesh` over every
    device."""
    if not dist.is_initialized():
        return make_mesh(device="cuda" if device is None else device)
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(device)


def put_replicated(mesh: Mesh, x) -> torch.Tensor:
    """A value every process holds, on the rank's device."""
    return torch.as_tensor(x, device=mesh.device)


def put_sharded(mesh: Mesh, x) -> torch.Tensor:
    """This rank's block of rows of the FULL value (every process passes
    the same complete array and keeps its own block).  The rows must
    divide by the mesh size.  For a pipeline in which each process only
    holds its own block, use :func:`put_local_shards`."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"put_sharded: {n} rows do not divide over {mesh.size} ranks")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)


def put_local_shards(mesh: Mesh, x_local) -> torch.Tensor:
    """The block of rows this process already holds, on its device."""
    return torch.as_tensor(x_local, device=mesh.device)


def gather_sharded(mesh: Mesh, x_local: torch.Tensor) -> torch.Tensor:
    """The full array from every rank's block of rows, on every rank."""
    return mesh.all_gather(x_local).flatten(0, 1)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
