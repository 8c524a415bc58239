"""Optimizer and learning-rate schedule.

Port of ``rvt_tpu/training/optimizer.py``, which chains (under
``optax.flatten``) a global-norm gradient clip and AdamW with a OneCycle
schedule of two linear segments (upstream ``modules/detection.py:
360-392``, clip 1.0 from ``train.py:122``). The update follows optax's
arithmetic, op by op:

  * clip: when ||g|| >= max_norm, g = (g / ||g||) * max_norm (optax scales
    only then; ``clip_grad_norm_`` would add 1e-6), computed on the device
    as g / d * m with d, m = ||g||, max_norm when clipping and 1, 1
    otherwise (both exact then);
  * Adam: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, each divided by
    1 - b^(count+1) in f32; u = mu_hat / (sqrt(nu_hat) + eps), eps = 1e-8
    outside the root; decoupled weight decay u += wd * p;
  * p += -lr(count) * u, with the schedule at count = 0 on the first step
    (max_lr / div_factor).

The moments are f32 tensors beside the parameters; the update runs as
``torch._foreach_*`` ops over all of them. The learning rate and the two
bias corrections are computed on the host in f32, as optax's schedule
computes them, and reach the device before each step as one small
stream-ordered copy (``load_scalars``); ``update`` reads them there and
reads nothing back, so a train step can be captured as a CUDA graph. The
gradients stay in the same tensors from step to step (``zero_grad``
zeroes them in place) for the same reason: views of one flat f32 buffer,
which data parallelism sums over the ranks in one all-reduce
(``reduce_grads``) before the clip reads it, as JAX's clip and
``grad_norm`` see the global gradient. The optimizer is not a TPU kernel
in the JAX package and is not one here.
"""
from __future__ import annotations

from typing import Callable, Iterable, List

import numpy as np
import torch
import torch.distributed as dist

from rvt_tpu_torch.config import TrainingConfig

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule in f32: (init - end) * (1 - c / steps) + end
    with c clipped to [0, steps]; constant ``init`` when steps <= 0."""
    if steps <= 0:
        return lambda count: float(np.float32(init))

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return schedule


def onecycle_schedule(cfg: TrainingConfig) -> Callable[[int], float]:
    """The learning rate at optimizer step ``count`` (0 on the first)."""
    s = cfg.lr_scheduler
    max_lr = cfg.learning_rate
    if not s.use:
        return lambda count: float(np.float32(max_lr))
    warmup = int(s.pct_start * s.total_steps)
    first = _linear(max_lr / s.div_factor, max_lr, warmup)
    second = _linear(max_lr, max_lr / s.final_div_factor,
                     s.total_steps - warmup)
    return lambda count: first(count) if count < warmup else second(
        count - warmup)


class OneCycleAdamW:
    """Global-norm clip + AdamW + OneCycle over ``params`` (f32). ``step``
    reads each parameter's ``.grad`` (None counts as zero), leaves it
    unchanged, updates the parameters in place and returns the norm of the
    raw gradients (the ``grad_norm`` metric): ``load_scalars`` on the
    host, then ``update`` on the device."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 cfg: TrainingConfig):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_norm = float(cfg.gradient_clip_val)
        self.weight_decay = float(cfg.weight_decay)
        self.schedule = onecycle_schedule(cfg)
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.count = 0
        dev = self.params[0].device if self.params else torch.device("cpu")
        # this step's bias corrections 1 - b1^n, 1 - b2^n and -lr(count)
        self.scalars = torch.zeros(3, dtype=torch.float32, device=dev)
        self._max_norm = torch.tensor(self.max_norm, dtype=torch.float32,
                                      device=dev)
        self._flat = None   # one buffer behind every gradient
        self._grads = None  # its views, what zero_grad sets as each .grad

    def state_dict(self) -> dict:
        """The moments and the step count (what a checkpoint keeps)."""
        return {"mu": list(self.mu), "nu": list(self.nu),
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` into the moments in place."""
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(state[key]) != len(dst):
                raise ValueError(f"optimizer state has {len(state[key])} "
                                 f"{key} tensors, expected {len(dst)}")
            for d, s in zip(dst, state[key]):
                d.copy_(s)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        """Zero the gradients in place: the optimizer owns one view a
        parameter of one flat buffer (made on first use) and sets it as
        ``.grad`` again if it was replaced, so that a captured step writes
        memory that stays allocated from step to step."""
        if self._grads is None:
            dtypes = {(p.dtype, p.device) for p in self.params}
            if len(dtypes) != 1:
                raise ValueError("the optimizer takes parameters of one "
                                 f"dtype on one device, got {dtypes}")
            self._flat = torch.zeros(sum(p.numel() for p in self.params),
                                     dtype=self.params[0].dtype,
                                     device=self.params[0].device)
            self._grads, off = [], 0
            for p in self.params:
                self._grads.append(self._flat[off:off + p.numel()].view(
                    p.shape))
                off += p.numel()
        for p, g in zip(self.params, self._grads):
            if p.grad is not g:
                p.grad = g
        self._flat.zero_()

    def reduce_grads(self, group) -> None:
        """Sum the gradients over the data-parallel ``group`` in place, as
        one flat all-reduce (after ``zero_grad`` and the backward)."""
        dist.all_reduce(self._flat, group=group)

    def load_scalars(self) -> None:
        """Host side of a step: count it and copy its learning rate and
        bias corrections, computed in f32 as optax does, to the device
        (from pinned memory on a card: ordered on the stream, no wait)."""
        n = self.count + 1
        host = torch.tensor(
            [np.float32(1) - np.float32(B1) ** np.float32(n),
             np.float32(1) - np.float32(B2) ** np.float32(n),
             -self.schedule(self.count)], dtype=torch.float32)
        if self.scalars.is_cuda:
            host = host.pin_memory()
        self.scalars.copy_(host, non_blocking=True)
        self.count = n

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """Device side of a step: clip, AdamW, the parameters in place,
        from ``scalars``; returns the raw gradients' norm. No host read."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norms = torch._foreach_norm(grads)
        g_norm = torch.linalg.vector_norm(torch.stack(norms))
        clip = g_norm >= self._max_norm
        one = torch.ones_like(g_norm)
        grads = torch._foreach_div(grads, torch.where(clip, g_norm, one))
        torch._foreach_mul_(grads, torch.where(clip, self._max_norm, one))
        t = torch._foreach_mul(grads, 1.0 - B1)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, t)
        t = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(t, 1.0 - B2)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, t)
        bc1, bc2, neg_lr = self.scalars.unbind()
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, EPS)
        upd = torch._foreach_div(mu_hat, nu_hat)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                        self.weight_decay))
        torch._foreach_mul_(upd, neg_lr)
        torch._foreach_add_(self.params, upd)
        return g_norm

    def step(self) -> torch.Tensor:
        self.load_scalars()
        return self.update()


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainingConfig) -> OneCycleAdamW:
    return OneCycleAdamW(params, cfg)
