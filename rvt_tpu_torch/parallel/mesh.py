"""Data parallelism over processes: the port's counterpart of
``rvt_tpu/parallel/mesh.py``.

The JAX package shards the global batch over a 1-D ``dp`` mesh axis,
replicates the parameters and jits one program over the mesh, so XLA
computes the global-batch function: the loss normalised by the whole
batch's foreground count, BatchNorm moments over every device's frames,
one gradient, one update. The port runs one process a card
(``torchrun``) on ``torch.distributed`` and places the collectives that
function needs by hand, in the train step (``training/step.py``): the
foreground and GT counts summed before the clamp
(``training/losses.py``), each train-mode BatchNorm's mean and mean
square averaged over the ranks (``ops/bn_act.py``), and the gradients
summed as one flat buffer before the clip (``training/optimizer.py``).
With one rank each of them is the identity, so the dp step is the
single-card step bit for bit.

Every rank builds the identical global batch from the same seed and
keeps its lanes ``[r B / W, (r + 1) B / W)`` (``DataParallel.lanes``:
JAX's ``shard_batch_arrays`` and ``shard_states`` in one slice, which the
Trainer applies to each batch and sizes the LSTM states by); parameters
and buffers are broadcast from rank 0
(``replicate_tree``) after init and every load, so the replicas are equal
by construction rather than by identical initialisation.

JAX's single-process multi-device mesh has no counterpart: the port's
unit is a process per card, so ``dp_size`` counts processes.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


@dataclass(frozen=True)
class DataParallel:
    """The dp world this process belongs to: ``group`` (None in a
    process without a process group), this process's ``rank`` and the
    ``world`` size, and the ``backend`` ("nccl", "gloo", or "none")."""
    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def lanes(self, batch_size: int) -> slice:
        """This rank's lanes of a global batch of ``batch_size``; raises
        ValueError where the world does not divide it (as JAX's
        ``device_put`` refuses such a sharding)."""
        if batch_size % self.world:
            raise ValueError(
                f"a batch of {batch_size} lanes does not split over "
                f"{self.world} data-parallel processes")
        n = batch_size // self.world
        return slice(self.rank * n, (self.rank + 1) * n)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL where each rank of this host has its own card, gloo where
    ranks share one or run on the CPU. NCCL refuses two ranks on one
    card, so this is decided up front and never switched silently."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_process_group(device="cuda", *, init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> torch.device:
    """Join the dp process group and return this rank's device.

    Without ``init_method`` the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a missing variable raises, naming it. A
    ``file://`` store with ``rank`` and ``world_size`` serves tests and
    ranks spawned on one host (local rank = rank). On a card the rank
    takes ``cuda:LOCAL_RANK`` when each rank has its own card (NCCL), else
    the card ``LOCAL_RANK % device_count`` shared over gloo. A process
    that has joined a group already keeps it."""
    device = torch.device(device)
    if dist.is_initialized():
        return (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else device)
    if init_method is None:
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "multi-process training needs torchrun's environment; "
                f"missing {', '.join(missing)} (launch with torchrun "
                "--nproc_per_node=N -m rvt_tpu_torch.cli.train "
                "--multihost ...)")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("init_method needs rank and world_size")
    else:
        local_rank, local_world = rank, world_size
    chosen = choose_backend(device, local_world)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    print(f"rvt_tpu_torch.parallel: rank {rank} of {world_size}, backend "
          f"{chosen} on {device}", file=sys.stderr, flush=True)
    dist.init_process_group(chosen, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


def make_mesh(dp_size: int = -1) -> DataParallel:
    """The dp world of this process. ``dp_size`` counts processes: -1
    means the world size; any other value that differs from it raises,
    saying how many processes to launch."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
    else:
        group, world, rank, backend = None, 1, 0, "none"
    if dp_size not in (-1, world):
        raise ValueError(
            f"dp_size={dp_size}, but this world has {world} process(es): "
            "the port runs one process a card, so launch dp_size processes "
            "(torchrun --nproc_per_node=N -m rvt_tpu_torch.cli.train "
            "--multihost ...) or pass dp_size -1")
    return DataParallel(group, rank, world, backend)


@torch.no_grad()
def replicate_tree(mesh: DataParallel,
                   tensors: Sequence[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 in place (one call a dtype, over
    a flat copy); nothing to do in a world of one."""
    if mesh.world == 1:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, 0, group=mesh.group)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def module_tensors(module: torch.nn.Module):
    """Every parameter and buffer of ``module`` (what a replica holds)."""
    return list(module.state_dict(keep_vars=True).values())


def same_on_all_ranks(mesh: DataParallel, tensors) -> bool:
    """Whether ``tensors`` are bit for bit those of rank 0 on every rank
    (a check for tests and the chip script: the replicas' equality)."""
    if mesh.world == 1:
        return True
    ok = torch.ones((), dtype=torch.int32,
                    device=tensors[0].device if mesh.backend == "nccl"
                    else "cpu")
    for t in tensors:
        ref = t.detach().clone()
        dist.broadcast(ref, 0, group=mesh.group)
        if not torch.equal(ref, t.detach()):
            ok.zero_()
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(ok.item())

