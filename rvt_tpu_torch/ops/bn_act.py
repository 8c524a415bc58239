"""Train-mode BatchNorm and its activation (the YOLOX neck's and head's
``BaseConv``) as one autograd Function over hand-written kernels.

The JAX package leaves flax's ``nn.BatchNorm`` (``rvt_tpu/models/yolox.py:
BaseConv``) to XLA, which fuses it; no TPU kernel replaces it. The math
is flax's: f32 moments over (N, H, W) of the conv output y, the fast
variance max(E[y^2] - E[y]^2, 0) (biased), z = (y - mean) * (rsqrt(var +
eps) * scale) + bias, then the activation in f32; the running buffers
become ``momentum * ra + (1 - momentum) * batch`` with the biased
variance. Under a data-parallel group the mean and E[y^2] are the
averages of every rank's (each rank gathers as many frames), and the
backward sums the moments' cotangents over the ranks.

Two passes each way (``csrc/bn_act.cu``):

  forward   ``bn_moments``: this rank's mean and E[y^2] [2, C] (one read
            of y); under a group an all-reduce of them; ``bn_act_fwd``:
            act(z) in f32, and the running buffers updated
  backward  ``bn_act_bwd_sums``: with dz = g * act'(z), the sums of dz and
            dz * (y - mean) [2, C], and from them this rank's scale and
            bias gradients; under a group an all-reduce of the sums;
            ``bn_act_bwd_dy``: dy = mul * (dz - sum dz / n) + coef * (y -
            mean) in y's dtype, coef = -scale * rstd^3 * sum dz (y - mean)
            / n, 0 where the clamp held the variance at 0

so z is never stored: the backward recomputes it from y. The edges keep
the module's dtypes: y as the conv leaves it (bf16, or f32 where the conv
runs in f32), the activation f32, the incoming gradient f32, dy in y's
dtype. On a CUDA tensor the kernels run (or the wrapper raises); on the
CPU, or with ``plain=True``, the plain versions here, the same two-pass
formulation in PyTorch ops.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.fused_attention import _RED_TICKETS, _reduce_workspace
from rvt_tpu_torch.ops.kernels import Counter, check, need, ptr, stream_ptr

BN_ACT = Counter("bn_act")
ACTS = {"silu": 0, "relu": 1, "lrelu": 2}  # csrc/bn_act.cu's ACT_*
_THREADS, _UNROLL = 256, 4  # csrc/bn_act.cu's THREADS, UNROLL
# The most blocks a reduction launches: one wave of a 132-SM H100 at four
# blocks an SM for the moments, two for the backward's sums (more
# registers a thread, and each block's finish weighs more). Constants, not
# the card's count, so that the sum order is the shape's alone; the
# fastest of 132-528 on the train cells' shapes, on the card.
_MOMENT_BLOCKS, _SUM_BLOCKS = 528, 264
_MAX_CHUNKS = 32   # chunks of a channel: partials the finishing block adds
_GRID = 1056       # the elementwise passes' most blocks (8 an SM), grid-stride


class BnPlan(NamedTuple):
    chunks: int  # each channel's elements split into chunks, a block each
    rows: int    # a chunk: vectors of a channel (CHW) or rows (HWC)
    tx: int      # HWC: channel vectors a block's tile (CHW: 1)


@functools.lru_cache(maxsize=None)
def bn_plan(chw: bool, N: int, C: int, S: int, vec: int,
            blocks: int) -> BnPlan:
    """How a reduction of ``csrc/bn_act.cu`` splits an [N, C, S] tensor
    loaded ``vec`` elements at a time: a function of the shape alone, so
    the sum order is the same on every card. CHW: a block a (chunk,
    channel), at most ``blocks`` blocks where the channels allow, each
    thread at least two vectors. HWC: tiles of ``tx`` channel vectors (a
    power of two up to 32) by 256 // tx row lanes, row chunks up to
    ``blocks`` blocks, each lane at least two batches of ``_UNROLL``
    rows."""
    if chw:
        nq = N * S // vec
        chunks = max(1, min(blocks // C, nq // (2 * _THREADS), _MAX_CHUNKS))
        rows = -(-nq // chunks)
        return BnPlan(-(-nq // rows), rows, 1)
    M, nv = N * S, C // vec
    tx = min(1 << (nv - 1).bit_length(), 32)
    tiles = -(-nv // tx)
    chunks = max(1, min(blocks // tiles,
                        M // (2 * (_THREADS // tx) * _UNROLL), _MAX_CHUNKS))
    rows = -(-M // chunks)
    return BnPlan(-(-M // rows), rows, tx)


# ---------------------------------------------------------------------------
# Plain versions (the CPU's route, and the card's yardstick)
# ---------------------------------------------------------------------------


def _c(v: torch.Tensor) -> torch.Tensor:
    """A per-channel [C] vector broadcast over [N, C, H, W]."""
    return v[:, None, None]


def _stats(mom: torch.Tensor, world: int, eps: float, weight: torch.Tensor):
    """(mean, clamped var, rstd, rstd * scale, variance not clamped) from
    the moments [2, C] summed over ``world`` ranks."""
    mean, mean_sq = (mom / world).unbind(0)
    raw = mean_sq - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return mean, var, rstd, rstd * weight, raw >= 0


def activation(act: str, z: torch.Tensor) -> torch.Tensor:
    """``act`` ("silu", "relu" or "lrelu": leaky relu 0.1) of z."""
    if act == "silu":
        return torch.nn.functional.silu(z)
    if act == "relu":
        return torch.relu(z)
    if act == "lrelu":
        return torch.nn.functional.leaky_relu(z, 0.1)
    raise NotImplementedError(act)


def _act_grad(act: str, z: torch.Tensor) -> torch.Tensor:
    """d act / d z as PyTorch's backward of each takes it (0 and 0.1 at
    z = 0)."""
    if act == "silu":
        s = torch.sigmoid(z)
        return s * (1 + z * (1 - s))
    if act == "relu":
        return (z > 0).float()
    if act == "lrelu":
        return torch.where(z > 0, 1.0, 0.1)
    raise NotImplementedError(act)


def moments_plain(y: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    return torch.stack([yf.mean((0, 2, 3)), (yf * yf).mean((0, 2, 3))])


def act_fwd_plain(y, mom, world, weight, bias, eps, act, running=None,
                  momentum=0.9):
    mean, var, _, mul, _ = _stats(mom, world, eps, weight)
    if running is not None:
        with torch.no_grad():
            for buf, batch in zip(running, (mean, var)):
                buf.copy_(momentum * buf + (1 - momentum) * batch)
    return activation(act, (y.float() - _c(mean)) * _c(mul) + _c(bias))


def _dz(y, g, mom, world, weight, bias, eps, act):
    mean, _, rstd, mul, open_ = _stats(mom, world, eps, weight)
    d = y.float() - _c(mean)
    dz = g * _act_grad(act, d * _c(mul) + _c(bias))
    return d, dz, rstd, mul, open_


def bwd_sums_plain(y, g, mom, world, weight, bias, eps, act):
    d, dz, rstd, _, _ = _dz(y, g, mom, world, weight, bias, eps, act)
    a, b = dz.sum((0, 2, 3)), (dz * d).sum((0, 2, 3))
    return torch.stack([a, b]), torch.stack([b * rstd, a])


def bwd_dy_plain(y, g, mom, sums, world, weight, bias, eps, act):
    d, dz, rstd, mul, open_ = _dz(y, g, mom, world, weight, bias, eps, act)
    n = world * (y.numel() // y.shape[1])
    a, b = sums.unbind(0)
    coef = torch.where(open_, -(weight * (rstd * rstd * rstd) * b) / n, 0.0)
    return ((dz - _c(a / n)) * _c(mul) + _c(coef) * d).to(y.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# The operand checks format their message only on failure: formatting it
# at every launch would be most of a launch's host time (kernels.py's
# check_operands).


def _geometry(y: torch.Tensor) -> Tuple[bool, int, int, int]:
    """(chw, N, C, S) of a conv output contiguous as NCHW (chw) or
    channels_last; raises on any other layout."""
    if not (y.is_cuda and y.dim() == 4
            and y.dtype in (torch.bfloat16, torch.float32)):
        raise ValueError(f"bn_act: y must be a 4-D bf16/f32 CUDA tensor "
                         f"(got {y.device}, {y.dtype}, {tuple(y.shape)})")
    N, C, H, W = y.shape
    chw = y.is_contiguous()
    # a CHW reduction takes a ticket a channel
    if not ((chw or y.is_contiguous(memory_format=torch.channels_last))
            and 0 < C <= _RED_TICKETS and N * H * W > 0
            and y.numel() < 2 ** 31):
        raise ValueError(
            f"bn_act: y must be contiguous as NCHW or channels_last, with 1 "
            f"to {_RED_TICKETS} channels and under 2^31 elements (got "
            f"{tuple(y.shape)}, strides {y.stride()})")
    return chw, N, C, H * W


def _params(C: int, *vs: Optional[torch.Tensor]) -> None:
    for v in vs:
        if not (v is None or (v.is_cuda and v.dtype == torch.float32
                              and v.is_contiguous() and v.numel() == C)):
            raise ValueError(
                f"bn_act: per-channel tensors must be f32 [{C}] on the card")


def _grad_operand(g: torch.Tensor, y: torch.Tensor,
                  chw: bool) -> Tuple[torch.Tensor, int]:
    """The incoming gradient in y's layout and its free stride: a sample
    stride (CHW) or row stride (HWC), so that a channel slice of a wider
    gradient (a concatenation's backward) is read in place; any other
    layout is copied into y's."""
    if not (g.is_cuda and g.dtype == torch.float32 and g.shape == y.shape):
        raise ValueError(
            f"bn_act: the gradient must be f32 {tuple(y.shape)} on the card "
            f"(got {g.dtype} {tuple(g.shape)})")
    N, C, H, W = y.shape
    s = g.stride()
    if chw and s[1:] == y.stride()[1:] and (N == 1 or s[0] >= C * H * W):
        return g, (s[0] if N > 1 else C * H * W)
    if (not chw and s[1] == 1 and s[2] == W * s[3] and s[3] >= C
            and (N == 1 or s[0] == H * s[2])):
        return g, s[3]
    g = g.contiguous(memory_format=torch.contiguous_format if chw
                     else torch.channels_last)
    return g, (C * H * W if chw else C)


def _vec(y: torch.Tensor, chw: bool, S: int, g: Optional[torch.Tensor] = None,
         g_stride: int = 0) -> int:
    """Elements a thread loads at once: 16 bytes of y where the shape, the
    gradient's stride and the pointers allow it, else fewer."""
    isz = y.element_size()
    along = S if chw else y.shape[1]
    v = 16 // isz
    while v > 1 and (along % v or y.data_ptr() % (v * isz) or (
            g is not None and (g_stride % v or g.data_ptr() % (4 * v)))):
        v //= 2
    return v


def moments(y: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """[2, C] f32: the mean and E[y^2] of each channel of y [N, C, H, W]
    over (N, H, W)."""
    if plain or not y.is_cuda:
        return moments_plain(y)
    chw, N, C, S = _geometry(y)
    vec = _vec(y, chw, S)
    plan = bn_plan(chw, N, C, S, vec, _MOMENT_BLOCKS)
    out = torch.empty((2, C), dtype=torch.float32, device=y.device)
    tickets, part = _reduce_workspace(y, plan.chunks * 2 * C)
    err = kernels.lib("bn_act").rvt_bn_moments(
        ptr(y), int(y.dtype == torch.float32), ptr(out), int(chw), N, C, S,
        vec, *plan, ptr(part), ptr(tickets), stream_ptr(y))
    check(err, "bn_moments")
    BN_ACT.launches += 1
    return out


def act_fwd(y, mom, world: int, weight, bias, eps: float, act: str,
            running=None, momentum: float = 0.9, *, plain: bool = False):
    """act(BatchNorm(y)) in f32, y's layout, from the moments [2, C]
    summed over ``world`` ranks; ``running`` (mean, var), when given, is
    updated in place."""
    if plain or not y.is_cuda:
        return act_fwd_plain(y, mom, world, weight, bias, eps, act, running,
                             momentum)
    chw, N, C, S = _geometry(y)
    rm, rv = running if running is not None else (None, None)
    _params(C, weight, bias, rm, rv)
    need(mom.shape == (2, C) and mom.is_contiguous()
         and mom.dtype == torch.float32, "bn_act: f32 moments [2, C]")
    vec = _vec(y, chw, S)
    out = torch.empty_like(y, dtype=torch.float32)
    grid = min(-(-y.numel() // (vec * _THREADS)), _GRID)
    err = kernels.lib("bn_act").rvt_bn_act_fwd(
        ptr(y), int(y.dtype == torch.float32), ptr(out), ptr(mom),
        ptr(weight), ptr(bias), None if rm is None else ptr(rm),
        None if rv is None else ptr(rv), int(chw), N, C, S, vec, grid,
        float(world), float(eps), float(momentum), float(1 - momentum),
        ACTS[act], stream_ptr(y))
    check(err, "bn_act_fwd")
    BN_ACT.launches += 1
    return out


def bwd_sums(y, g, mom, world: int, weight, bias, eps: float, act: str, *,
             plain: bool = False):
    """The backward's first pass: ([2, C] the sums of dz and dz * (y -
    mean) over this rank's elements, [2, C] this rank's scale and bias
    gradients)."""
    if plain or not y.is_cuda:
        return bwd_sums_plain(y, g, mom, world, weight, bias, eps, act)
    chw, N, C, S = _geometry(y)
    _params(C, weight, bias)
    g, g_stride = _grad_operand(g, y, chw)
    vec = _vec(y, chw, S, g, g_stride)
    plan = bn_plan(chw, N, C, S, vec, _SUM_BLOCKS)
    sums = torch.empty((2, C), dtype=torch.float32, device=y.device)
    dparams = torch.empty_like(sums)
    tickets, part = _reduce_workspace(y, plan.chunks * 2 * C)
    err = kernels.lib("bn_act").rvt_bn_act_bwd_sums(
        ptr(y), int(y.dtype == torch.float32), ptr(g), g_stride, ptr(mom),
        ptr(weight), ptr(bias), ptr(sums), ptr(dparams), int(chw), N, C, S,
        vec, *plan, float(world), float(eps), ACTS[act], ptr(part),
        ptr(tickets), stream_ptr(y))
    check(err, "bn_act_bwd_sums")
    BN_ACT.launches += 1
    return sums, dparams


def bwd_dy(y, g, mom, sums, world: int, weight, bias, eps: float, act: str,
           *, plain: bool = False):
    """The backward's second pass: y's gradient in y's dtype and layout,
    from the first pass's sums summed over the ranks."""
    if plain or not y.is_cuda:
        return bwd_dy_plain(y, g, mom, sums, world, weight, bias, eps, act)
    chw, N, C, S = _geometry(y)
    _params(C, weight, bias)
    g, g_stride = _grad_operand(g, y, chw)
    vec = _vec(y, chw, S, g, g_stride)
    dy = torch.empty_like(y)
    grid = min(-(-y.numel() // (vec * _THREADS)), _GRID)
    err = kernels.lib("bn_act").rvt_bn_act_bwd_dy(
        ptr(y), int(y.dtype == torch.float32), ptr(g), g_stride, ptr(mom),
        ptr(weight), ptr(bias), ptr(sums), ptr(dy), int(chw), N, C, S, vec,
        grid, float(world), float(eps), ACTS[act], stream_ptr(y))
    check(err, "bn_act_bwd_dy")
    BN_ACT.launches += 1
    return dy


class BatchNormActTrain(torch.autograd.Function):
    """act(train-mode BatchNorm(y)) with y's, scale's and bias's
    gradients; the running buffers updated in the forward. Under a group
    one all-reduce of the moments [2, C] forward and one of the first
    pass's sums [2, C] backward: the scale and bias gradients stay this
    rank's (the optimizer sums them), y's takes every rank's sums."""

    @staticmethod
    def forward(ctx, y, weight, bias, running, eps, momentum, act, group,
                plain):
        world = 1 if group is None else dist.get_world_size(group)
        mom = moments(y, plain=plain)
        if group is not None:
            dist.all_reduce(mom, group=group)
        out = act_fwd(y, mom, world, weight, bias, eps, act, running,
                      momentum, plain=plain)
        ctx.save_for_backward(y, mom, weight, bias)
        ctx.cfg = (world, eps, act, group, plain)
        return out

    @staticmethod
    def backward(ctx, g):
        y, mom, weight, bias = ctx.saved_tensors
        world, eps, act, group, plain = ctx.cfg
        sums, dparams = bwd_sums(y, g, mom, world, weight, bias, eps, act,
                                 plain=plain)
        if group is not None:
            dist.all_reduce(sums, group=group)
        dy = bwd_dy(y, g, mom, sums, world, weight, bias, eps, act,
                    plain=plain)
        return dy, dparams[0], dparams[1], None, None, None, None, None, None


def batch_norm_act_train(y: torch.Tensor, bn: torch.nn.BatchNorm2d, act: str,
                         group=None, momentum: float = 0.9, *,
                         plain: bool = False) -> torch.Tensor:
    """act(BatchNorm(y)) in train mode, f32 out, ``bn``'s running buffers
    updated (flax's ``nn.BatchNorm(use_running_average=False)`` then the
    activation); with ``group``, on the moments of every rank's frames."""
    if act not in ACTS:
        raise NotImplementedError(act)
    return BatchNormActTrain.apply(
        y, bn.weight, bn.bias, (bn.running_mean, bn.running_var), bn.eps,
        momentum, act, group, plain)
