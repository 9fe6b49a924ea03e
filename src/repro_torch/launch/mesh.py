"""The ("data", "model") process grid of the sharded CTR placements.

A port of ``repro.launch.mesh``'s CTR half. The JAX package runs one
process over a mesh of devices under ``shard_map``; the port runs one
process a rank over a two-dimensional
``torch.distributed.device_mesh.init_device_mesh`` grid, rank ``d * M +
m`` at data coordinate ``d`` and model coordinate ``m``. Each of the
reference's ``psum``, ``all_gather`` and ``pmax`` over a named axis is a
collective on that axis's sub-group (``CtrMesh.data_group``,
``model_group``), issued whatever the group's size: a size-1 group costs
its collective, where XLA elides a ``psum`` over a size-1 axis.

Backends: ``nccl`` for ranks on the card (one card a rank: NCCL refuses
two ranks on one device), ``gloo`` for CPU ranks. The default process
group comes from the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``) when it is set, else from a ``FileStore``
in a directory (a fresh temporary one for a world of 1); no TCP port is
chosen here. ``spawn_host_ranks`` is the counterpart of the reference's
``force_host_device_count``: N gloo CPU ranks in spawned processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def parse_mesh(spec: str) -> tuple:
    """Parse a ``--mesh`` flag: "2,4" or "2x4" -> (data=2, model=4)."""
    parts = spec.replace("x", ",").split(",")
    if len(parts) != 2:
        raise ValueError(
            f"--mesh wants DATA,MODEL (e.g. '2,4'), got {spec!r}")
    data, model = (int(p) for p in parts)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return data, model


def backend_for(device) -> str:
    """The collective backend of ranks on ``device``: nccl on the card,
    gloo on the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def under_torchrun() -> bool:
    return all(k in os.environ for k in TORCHRUN_ENV)


@contextlib.contextmanager
def process_group(device, *, rank: int = 0, world_size: int = 1,
                  store_path: Optional[str] = None):
    """The default process group for ranks on ``device`` for the body of
    the ``with``, destroyed on the way out whatever happens (NCCL's
    watchdog and heartbeat threads end with it). Under ``torchrun`` the
    environment gives rank, world and rendezvous (``rank``/``world_size``
    are then ignored, and a CUDA rank takes the card ``LOCAL_RANK``);
    otherwise a ``FileStore`` at ``store_path``, shared by every rank of
    the world (a fresh temporary file for a world of 1). Yields the
    rank's device."""
    device = torch.device(device)
    backend = backend_for(device)
    with contextlib.ExitStack() as stack:
        if under_torchrun():
            if device.type == "cuda":
                device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
                torch.cuda.set_device(device)
            dist.init_process_group(backend, init_method="env://")
        else:
            if store_path is None:
                if world_size != 1:
                    raise ValueError("a world of more than one rank needs "
                                     "the store_path its ranks share")
                tmp = stack.enter_context(tempfile.TemporaryDirectory())
                store_path = os.path.join(tmp, "store")
            if device.type == "cuda":
                device = torch.device("cuda", device.index or 0)
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend, store=dist.FileStore(store_path, world_size),
                rank=rank, world_size=world_size)
        try:
            yield device
        finally:
            dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class CtrMesh:
    """One rank's view of the ("data", "model") grid: the axes' sizes,
    its coordinates, and the sub-group of each axis (the ranks that share
    its other coordinate)."""

    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object

    @property
    def rank(self) -> int:
        return self.data_rank * self.model + self.model_rank


def make_ctr_mesh(data: int = 0, model: int = 0, *,
                  device_type: str = "cuda") -> CtrMesh:
    """The grid of the sharded CTR placements over the initialized world.

    Unset axes (< 1) are filled from the world size, favoring the model
    axis (table rows are what CTR scaling runs out of): ``(0, 0)`` becomes
    ``(1, world)``. The grid must cover the world exactly."""
    if not dist.is_initialized():
        raise RuntimeError("make_ctr_mesh needs an initialized process "
                           "group (launch.mesh.process_group)")
    n = dist.get_world_size()
    if data < 1 and model < 1:
        data, model = 1, n
    elif data < 1:
        data = max(1, n // model)
    elif model < 1:
        model = max(1, n // data)
    if data * model != n:
        raise ValueError(
            f"mesh ({data}, {model}) needs {data * model} ranks, the world "
            f"has {n} (on the CPU pass --host-devices {data * model})")
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh(device_type, (data, model),
                            mesh_dim_names=MESH_AXES)
    return CtrMesh(data, model, grid.get_local_rank("data"),
                   grid.get_local_rank("model"), grid.get_group("data"),
                   grid.get_group("model"))


def spawn_host_ranks(fn: Callable, n: int, args: tuple = ()) -> None:
    """Run ``fn(rank, n, store_path, *args)`` in ``n`` spawned processes,
    the CPU ranks of one gloo world (``fn`` opens ``process_group("cpu",
    rank=rank, world_size=n, store_path=store_path)``). Joins them all.

    A rank that fails ends the world: ``torch.multiprocessing``'s join
    sends the others SIGTERM, then SIGKILL after 30 s, and waits for
    every one of them, so no rank outlives this call (a rank blocked in a
    collective whose peer died would otherwise wait out gloo's 30-minute
    timeout). A rank that raised re-raises here. A rank killed by a signal
    N (a fault plan's SIGKILL) makes this process exit ``128 + N``, as a
    shell reports a killed command (137 for SIGKILL), after naming the
    lowest such rank on stderr."""
    import signal
    import sys

    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"--host-devices must be >= 1, got {n}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(fn, args=(n, os.path.join(tmp, "store"),
                                           *args),
                                 nprocs=n, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except (mp.ProcessExitedException, mp.ProcessRaisedException):
            killed = [(r, -p.exitcode) for r, p in enumerate(ctx.processes)
                      if p.exitcode is not None and p.exitcode < 0
                      and -p.exitcode != signal.SIGTERM]
            if not killed:
                raise
            rank, signum = killed[0]
            print(f"[train] rank {rank} of {n} was killed by "
                  f"{signal.Signals(signum).name}; the other ranks were "
                  f"ended", file=sys.stderr, flush=True)
            raise SystemExit(128 + signum) from None
