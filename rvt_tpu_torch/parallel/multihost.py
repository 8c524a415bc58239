"""Collectives for host-side data across processes: the port's
counterpart of ``rvt_tpu/parallel/multihost.py``.

The reference synchronises evaluation metrics with an explicit
``dist.barrier`` + ``dist.reduce(SUM)/world_size`` (reference
modules/detection.py:319-334). As in the JAX package, every process
instead gathers every other process's Prophesee buffers and scores the
identical full validation set, here in the same order everywhere.
``allgather_bytes`` exchanges variable-length byte strings as JAX's
does: the lengths first, then the payloads zero-padded to the longest,
trimmed per sender.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.distributed as dist


def _world(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def is_main_process() -> bool:
    """True on the process that owns shared side effects (checkpoint
    writes, publishes, panels, the metrics file). Reference: rank-0
    gating in train.py:60-67."""
    return _world() == 1 or dist.get_rank() == 0


def allgather_bytes(payload: bytes, group=None) -> List[bytes]:
    """Exchange one byte string per process; returns all of them in rank
    order. One process: the identity. Over NCCL the exchange goes
    through the current card, over gloo through the host."""
    if _world(group) == 1:
        return [payload]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    arr = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
    n = _world(group)
    length = torch.tensor([arr.numel()], dtype=torch.int64, device=device)
    lengths = [torch.empty_like(length) for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    lens = [int(x.item()) for x in lengths]
    padded = torch.zeros(max(max(lens), 1), dtype=torch.uint8, device=device)
    padded[:arr.numel()] = arr.to(device)
    gathered = [torch.empty_like(padded) for _ in range(n)]
    dist.all_gather(gathered, padded, group=group)
    return [g[:k].cpu().numpy().tobytes() for g, k in zip(gathered, lens)]


def merge_evaluator_buffers(evaluator, group=None) -> None:
    """Gather every process's Prophesee buffers into the local evaluator
    (in place): every process ends with the same buffer, rank 0's frames
    first, then rank 1's, and so on. (JAX's appends the others' frames
    after its own, so each process holds another order; the COCO
    protocol breaks ties between equal scores by that order, and the
    processes' metrics could then differ.) One process: nothing to do."""
    if _world(group) == 1:
        return
    payloads = allgather_bytes(evaluator.state_bytes(), group)
    evaluator.reset_buffer()
    for payload in payloads:
        evaluator.extend_from_bytes(payload)
