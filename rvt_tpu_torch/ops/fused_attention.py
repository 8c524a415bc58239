"""MaxViT attention pair on hand-written Hopper kernels.

Port of ``rvt_tpu/ops/fused_attention.py``. On the TPU one Pallas kernel
per image (``_blocks_kernel`` / ``_one_block``) runs a whole
PartitionAttention sub-block with every intermediate in VMEM. The pair
has no recurrence in time, so here it runs over all T*B frames at once as
a chain of three kernels (``csrc/``):

  K1 ``ln_rows``             LayerNorm rows (ds-LN, LN1, LN2)
  K2 ``gemm_bf16``           qkv / proj / fc1 / fc2 with fused epilogues
  K3 ``partition_attention`` per-(frame, partition) softmax attention over
                             a group of heads, softmax in registers

Tokens stay in image order: qkv, proj and the MLP act on each token
alone, so only K3 needs the window/grid partition, and it applies it in
its load and store addressing.

Numerics follow the JAX kernel: LayerNorm with f32 statistics (fast
variance) and bf16 output; every product accumulates in f32 and is
rounded to bf16 before its bf16 bias add; tanh-gelu; f32 softmax with
bf16 probabilities; LayerScale folded into proj/fc2 in f32 before the
bf16 cast; the residual stream R is f32 and is updated in place.

Each kernel has a plain PyTorch version beside it with the same rounding
points. A wrapper takes the plain version for CPU tensors, or when the
caller passes ``plain=True`` (the chip check holds the kernel path
against that); for a CUDA tensor it otherwise launches its kernel or
raises.

Training (``ops/fused_train.py``) adds the backward kernels of the pair:

  K2 ``gemm_bf16``           train epilogues: the unfolded-LayerScale
                             residual, a.w^T data gradients, the gelu
                             backward
  K5 ``ln_rows_bwd``         LayerNorm backward, ds/db partial sums
  K6 ``gemm_bf16_wgrad``     a^T.b weight gradients, rows split over blocks
  K7 ``partition_attention_bwd``  per-(frame, partition, head group)
                             backward, K3's softmax in registers
  ``train_reduce``           column sums (bias, gamma, split-sum passes)
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, sm_count, stream_ptr)

LN_ROWS = Counter("ln_rows")
GEMM_BF16 = Counter("gemm_bf16")
# K2's launches by the schedule they took (``gemm_schedule``), whichever
# counter a launch is credited to: tallies, not launches of their own
GEMM_BF16_PINGPONG = Counter("gemm_bf16.pingpong", tally=True)
GEMM_BF16_COOPERATIVE = Counter("gemm_bf16.cooperative", tally=True)
PARTITION_ATTENTION = Counter("partition_attention")
LN_ROWS_BWD = Counter("ln_rows_bwd")
GEMM_BF16_WGRAD = Counter("gemm_bf16_wgrad")
PARTITION_ATTENTION_BWD = Counter("partition_attention_bwd")
TRAIN_REDUCE = Counter("train_reduce")

# 0-3 take w [K, N] and a bias; the rt_ modes take w [N, K] (a . w^T) and
# no bias.
EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2, "residual_ls": 3,
             "rt_f32": 4, "rt_bf16": 5, "rt_acc": 6, "rt_gelu_bwd": 7}
_GEMM_PART_ROWS = 64  # rows of A per column-sum partial of "rt_gelu_bwd"


# ---------------------------------------------------------------------------
# Where the JAX package runs the pair on its kernels
# ---------------------------------------------------------------------------


def partition_geometry_ok(H: int, W: int, C: int,
                          part: Tuple[int, int]) -> bool:
    """``rvt_tpu/ops/fused_attention.py:partition_geometry_ok``: whether
    Mosaic can split the W axis into the window and grid partitions."""
    ph, pw = part
    if H % ph or W % pw:
        return False
    nw = W // pw

    def split_ok(outer: int, minor: int) -> bool:
        return outer == 1 or minor == 1 or (minor % 2 == 0
                                             and minor * C >= 128)

    return split_ok(nw, pw) and split_ok(pw, nw) and ph * pw >= 8


def dense_attention_ok(H: int, W: int) -> bool:
    """``rvt_tpu/ops/fused_attention.py:dense_attention_ok``."""
    return H * W <= 1024


def pair_fusion_ok(H: int, W: int, C: int, part: Tuple[int, int]) -> bool:
    """Whether ``rvt_tpu/ops/fused_attention.py:pair_fusion_mode`` is not
    None: the JAX package serves an H x W x C stage on its kernels (its
    partitioned or masked-dense path), and on its XLA modules (erf-gelu,
    LayerScale not folded) beyond 1M elements an image or where neither
    geometry fits (the port then runs its modules too,
    ``models/detector.py:stage_routes``). Only that outcome is copied: the
    Hopper kernels take both geometries alike."""
    if H * W * C > 1024 * 1024:
        return False
    return partition_geometry_ok(H, W, C, part) or dense_attention_ok(H, W)


# ---------------------------------------------------------------------------
# K1 ln_rows
# ---------------------------------------------------------------------------


def _ln_fwd(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float):
    """flax LayerNorm as the JAX kernels compute it (``_layer_norm_f32``,
    ``fused_train._ln_fwd``): f32 stats with the fast variance, affine in
    f32. Returns (y bf16, xhat f32, rstd f32)."""
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    y = xhat * scale.float().reshape(-1) + bias.float().reshape(-1)
    return y.to(torch.bfloat16), xhat, rstd


def _ln_bwd(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
            scale: torch.Tensor):
    """LayerNorm backward (``fused_train._ln_bwd``) on [M, C] rows.
    Returns (dx f32, ds [C], db [C])."""
    ds = (dy * xhat).sum(0)
    db = dy.sum(0)
    dxhat = dy * scale.float().reshape(-1)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), ds, db


def ln_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """flax LayerNorm as the JAX kernel computes it: bf16 result."""
    return _ln_fwd(x.float(), scale, bias, eps)[0]


_LN_NV_MAX = 8  # vectors a lane K1 is compiled for; wider rows: a warp a row


class LnRowsPlan(NamedTuple):
    vec: int    # elements a load (16 bytes where C allows, else 1)
    group: int  # lanes a row (a power of two up to 32): 32 / group rows a warp
    nv: int     # vectors a lane; 0: the wide kernel, a warp a row


@functools.lru_cache(maxsize=None)
def ln_rows_plan(C: int, itemsize: int) -> LnRowsPlan:
    """K1's lane map for rows of C elements of ``itemsize`` bytes: lane l
    of a row's group holds vectors l, l + group, ... (masked past C). It
    depends on C and the input type alone, so a row's result does not
    depend on M or the grid. The presets' widths fill every lane: the
    group is the largest power of two (up to 32) dividing the row's
    vectors; where that leaves more than 4 a lane, the row is spread over
    all 32 lanes."""
    vec = 16 // itemsize
    if C % vec:
        vec = 1
    nvec = C // vec
    group = min(nvec & -nvec, 32)
    nv = nvec // group
    if nv > 4:
        group, nv = 32, -(-nvec // 32)
    return LnRowsPlan(vec, group, nv if nv <= _LN_NV_MAX else 0)


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, *, with_f32: bool = False, plain: bool = False):
    """LayerNorm over the last axis of ``x`` (f32 or bf16) -> bf16. With
    ``with_f32`` also returns that result widened to f32 (the residual
    stream the downsample LN starts)."""
    if plain or not x.is_cuda:
        y = ln_rows_plain(x, scale, bias, eps)
        return (y, y.float()) if with_f32 else y
    C = x.shape[-1]
    s, b = scale.reshape(-1), bias.reshape(-1)
    check_operands("ln_rows", x, s, b)
    need(x.dtype in (torch.float32, torch.bfloat16)
         and s.dtype == b.dtype == torch.bfloat16 and s.numel() == C,
         "ln_rows: x f32/bf16 [..., C], scale/bias bf16 [C]")
    # empty_like: under half of torch.empty's host time (a launch's host
    # time paces the small per-step calls)
    y = torch.empty_like(x, dtype=torch.bfloat16)
    yf = torch.empty_like(x, dtype=torch.float32) if with_f32 else None
    M = x.numel() // C
    err = kernels.lib("ln_rows").rvt_ln_rows(
        x.data_ptr(), int(x.dtype == torch.float32), s.data_ptr(),
        b.data_ptr(), y.data_ptr(), yf.data_ptr() if with_f32 else None, M,
        C, float(eps), *ln_rows_plan(C, x.element_size()), sm_count(x),
        stream_ptr(x))
    check(err, "ln_rows")
    LN_ROWS.launches += 1
    return (y, yf) if with_f32 else y


# ---------------------------------------------------------------------------
# K2 gemm_bf16
# ---------------------------------------------------------------------------


_C0, _C1 = 0.7978845608028654, 0.044715  # sqrt(2/pi), the cubic term


def _gelu_tanh(xf: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's tanh-gelu (``fused_attention._gelu``), in f32."""
    inner = _C0 * (xf + _C1 * xf * xf * xf)
    return 0.5 * xf * (1.0 + torch.tanh(inner))


def _gelu_grad(hf: torch.Tensor) -> torch.Tensor:
    """d gelu / d h as ``fused_train._gelu_bwd`` writes it, in f32."""
    t = torch.tanh(_C0 * (hf + _C1 * hf * hf * hf))
    dinner = 0.5 * hf * (1.0 - t * t) * _C0 * (1.0 + 3.0 * _C1 * hf * hf)
    return 0.5 * (1.0 + t) + dinner


def gemm_bf16_plain(a: torch.Tensor, w: torch.Tensor, epilogue: str,
                    bias=None, gamma=None, res_in=None, out=None, aux=None):
    """The rounding points of each ``gemm_bf16`` epilogue. Returns what the
    wrapper returns, with the bf16 value before the epilogue beside the
    result of "gelu" and "residual_ls", and bf16(out) beside that of
    "residual"."""
    if epilogue.startswith("rt_"):
        acc = a.float() @ w.float().t()
        if epilogue == "rt_f32":
            return acc
        if epilogue == "rt_bf16":
            return acc.to(torch.bfloat16)
        if epilogue == "rt_acc":
            out += acc
            return out
        d = acc * _gelu_grad(aux.float())
        return d.to(torch.bfloat16), d.sum(0)
    v = (a.float() @ w.float()).to(torch.bfloat16)
    v = (v.float() + bias.float().reshape(-1)).to(torch.bfloat16)
    if epilogue == "bias":
        return v
    if epilogue == "gelu":
        return _gelu_tanh(v.float()).to(torch.bfloat16), v
    if epilogue == "residual":
        out += v.float()
        return out, out.to(torch.bfloat16)
    r = res_in + v.float() * gamma.reshape(-1)
    if out is None:
        return r, v
    out.copy_(r)
    return out, v


class GemmSchedule(NamedTuple):
    pingpong: bool   # else the cooperative schedule
    rows: int        # a tile's rows
    cols: int        # a tile's columns
    warpgroups: int  # consumer warpgroups a block


_F32_OUT = ("residual", "residual_ls", "rt_f32", "rt_acc")


@functools.lru_cache(maxsize=None)  # a launch's host time: few shapes
def gemm_schedule(M: int, N: int, K: int, epilogue: str,
                  sms: int) -> GemmSchedule:
    """K2's schedule and tile for ``epilogue`` at (M, N, K) on a card of
    ``sms`` SMs, as ``csrc/gemm_bf16.cu:schedule`` picks them: ping-pong
    (64-row tiles, two consumer warpgroups) where its tiles give every
    block two or more and the epilogue's memory traffic sets the pace (the
    f32 epilogues up to K = 1024, "bias" and "rt_bf16" up to K = 128);
    else cooperative: 64 rows where 128-row tiles would leave SMs idle,
    192 where N >= 2K, else 128. Columns: 128 where N is a multiple of
    128, else 64."""
    bn = 128 if N > 64 and N % 128 == 0 else 64
    n_tiles = -(-N // bn)
    if -(-M // 64) * n_tiles >= 2 * sms and (
            (epilogue in _F32_OUT and K <= 1024)
            or (epilogue in ("bias", "rt_bf16") and K <= 128)):
        return GemmSchedule(True, 64, bn, 2)
    if -(-M // 128) * n_tiles < sms:
        return GemmSchedule(False, 64, bn, 1)
    if N >= 2 * K:
        return GemmSchedule(False, 192, bn, 3)
    return GemmSchedule(False, 128, bn, 2)


def gemm_plan(M: int, N: int, K: int, epilogue: str) -> GemmSchedule:
    """What the compiled launcher picks for ``epilogue`` at (M, N, K) on
    the current card (``rvt_gemm_bf16_plan``; launches nothing)."""
    plan = (ctypes.c_int * 4)()
    check(kernels.lib("gemm_bf16").rvt_gemm_bf16_plan(
        M, N, K, EPILOGUES[epilogue], plan), "gemm_bf16_plan")
    return GemmSchedule(bool(plan[0]), plan[1], plan[2], plan[3])


def gemm_part_rows(M: int) -> int:
    """Rows of the f32 column-sum partials "rt_gelu_bwd" writes: one per
    64 rows of a (the launcher refuses any other count)."""
    return -(-M // _GEMM_PART_ROWS)


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, epilogue: str, *,
              bias=None, gamma=None, res_in=None, out=None, aux=None,
              want_aux: bool = False, plain: bool = False,
              counter: Counter = GEMM_BF16):
    """``a [M, K] bf16`` times a bf16 weight with f32 sums, then
    ``epilogue``. With w [K, N] and the bf16 ``bias [N]``, the product is
    rounded to bf16 and the bias added in bf16 (``v``):

      "bias"         v                                           -> bf16
      "gelu"         tanh-gelu of v                              -> bf16
      "residual"     ``out [M, N] f32 += v`` in place; returns out (the
                     serving proj / fc2, LayerScale folded into w, bias);
                     with ``want_aux`` (out, bf16(out))
      "residual_ls"  ``out = res_in + f32(v) * gamma`` (``out`` may be
                     ``res_in``; new when None); returns out (training:
                     LayerScale unfolded)

    with w [N, K] (a . w^T, the data gradients) and no bias:

      "rt_f32"       a . w^T                                     -> f32
      "rt_bf16"      bf16(a . w^T)
      "rt_acc"       ``out += a . w^T``; returns out
      "rt_gelu_bwd"  d = (a . w^T) * gelu'(aux = bf16 h1); returns
                     (bf16(d), f32 column sums of d)

    With ``want_aux`` "gelu" and "residual_ls" return (result, v).
    ``counter`` counts the launch: K4 (``fused_scan.fused_lstm_scan``)
    owns the input product it runs through this kernel."""
    need(epilogue in EPILOGUES, f"gemm_bf16: unknown epilogue {epilogue}")
    need(not want_aux or epilogue in ("gelu", "residual", "residual_ls"),
         "gemm_bf16: want_aux is for the gelu and residual epilogues")
    need((out is not None) or epilogue not in ("residual", "rt_acc"),
         "gemm_bf16: the residual and rt_acc epilogues add into out")
    if plain or not a.is_cuda:
        r = gemm_bf16_plain(a, w, epilogue, bias, gamma, res_in, out, aux)
        if epilogue in ("gelu", "residual", "residual_ls") and not want_aux:
            return r[0]
        return r
    M, K = a.shape
    rt = epilogue.startswith("rt_")
    N = w.shape[0] if rt else w.shape[1]
    check_operands("gemm_bf16", a, w)
    need(a.dtype == w.dtype == torch.bfloat16
         and w.shape[1 if rt else 0] == K and K % 8 == 0 and N % 8 == 0,
         "gemm_bf16: bf16 a [M, K], w [K, N] (or [N, K] for rt_); "
         "K and N multiples of 8")
    dev = a.device
    b = g = part = None
    if not rt:
        b = bias.reshape(-1)
        check_operands("gemm_bf16", b)
        need(b.dtype == torch.bfloat16 and b.numel() == N,
             "gemm_bf16: bias bf16 [N]")
    if epilogue == "residual_ls":
        g = gamma.reshape(-1)
        check_operands("gemm_bf16", g, res_in)
        need(g.dtype == res_in.dtype == torch.float32 and g.numel() == N
             and tuple(res_in.shape) == (M, N),
             "gemm_bf16: gamma f32 [N], res_in f32 [M, N]")
        if out is None:
            out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if epilogue in ("residual", "residual_ls", "rt_acc"):
        check_operands("gemm_bf16", out)
        need(out.dtype == torch.float32 and tuple(out.shape) == (M, N),
             "gemm_bf16: out must be f32 [M, N]")
    elif epilogue == "rt_f32":
        out = torch.empty((M, N), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    if epilogue == "rt_gelu_bwd":
        check_operands("gemm_bf16", aux)
        need(aux.dtype == torch.bfloat16 and tuple(aux.shape) == (M, N),
             "gemm_bf16: rt_gelu_bwd reads h1 bf16 [M, N]")
        part = torch.empty((gemm_part_rows(M), N), dtype=torch.float32,
                           device=dev)
    elif want_aux:
        aux = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    else:
        aux = None
    err = kernels.lib("gemm_bf16").rvt_gemm_bf16(
        ptr(a), ptr(w), ptr(b) if b is not None else None,
        ptr(g) if g is not None else None,
        ptr(res_in) if res_in is not None else None,
        ptr(aux) if aux is not None else None, ptr(out),
        ptr(part) if part is not None else None,
        part.shape[0] if part is not None else 0, M, N, K,
        EPILOGUES[epilogue], stream_ptr(a))
    check(err, "gemm_bf16")
    counter.launches += 1
    if gemm_schedule(M, N, K, epilogue, sm_count(a)).pingpong:
        GEMM_BF16_PINGPONG.launches += 1
    else:
        GEMM_BF16_COOPERATIVE.launches += 1
    if epilogue == "rt_gelu_bwd":
        return out, sum_parts(part)
    return (out, aux) if want_aux else out


# ---------------------------------------------------------------------------
# K3 partition_attention
# ---------------------------------------------------------------------------


def partition_attention_plain(qkv: torch.Tensor, heads: int, dim_head: int,
                              part: Tuple[int, int],
                              window: bool) -> torch.Tensor:
    """Window (``window``) or grid partition attention on the image-order
    qkv [N, H, W, 3C] bf16 (per-head interleaved q | k | v); returns the
    image-order head concat [N, H, W, C] bf16."""
    N, H, W, C3 = qkv.shape
    p = _partitions(qkv, part, window).reshape(
        -1, part[0] * part[1], heads, 3 * dim_head).float()
    o, _ = _attn_heads_fwd(p, dim_head)
    return _unpartitions(o.to(torch.bfloat16), (N, H, W, C3 // 3), part,
                         window)


def _partitions(t: torch.Tensor, part: Tuple[int, int],
                window: bool) -> torch.Tensor:
    """Image-order [N, H, W, D] -> [N * partitions, ph * pw, D] tokens."""
    N, H, W, D = t.shape
    ph, pw = part
    nh, nw = H // ph, W // pw
    if window:
        p = t.reshape(N, nh, ph, nw, pw, D).permute(0, 1, 3, 2, 4, 5)
    else:
        p = t.reshape(N, ph, nh, pw, nw, D).permute(0, 2, 4, 1, 3, 5)
    return p.reshape(N * nh * nw, ph * pw, D)


def _unpartitions(tok: torch.Tensor, shape, part: Tuple[int, int],
                  window: bool) -> torch.Tensor:
    """The inverse of ``_partitions`` back to ``shape`` [N, H, W, D]."""
    N, H, W, D = shape
    ph, pw = part
    nh, nw = H // ph, W // pw
    o = tok.reshape(N, nh, nw, ph, pw, D)
    if window:
        o = o.permute(0, 1, 3, 2, 4, 5)
    else:
        o = o.permute(0, 3, 1, 4, 2, 5)
    return o.reshape(N, H, W, D)


def _attn_heads_fwd(p: torch.Tensor, dh: int):
    """``fused_train._attn_heads_fwd`` on f32 tokens [P, n, heads, 3dh]:
    f32 softmax, bf16 probabilities. Returns (o [P, n, heads*dh] f32 of
    bf16-exact sums, probs [P, heads, n, n] f32 of bf16 values)."""
    q, k, v = p[..., :dh], p[..., dh:2 * dh], p[..., 2 * dh:]
    s = torch.einsum("pnhd,pmhd->phnm", q, k)
    probs = torch.softmax(s * (dh ** -0.5), dim=-1)
    probs = probs.to(torch.bfloat16).float()
    o = torch.einsum("phnm,pmhd->pnhd", probs, v)
    return o.reshape(p.shape[0], p.shape[1], -1), probs


def _attn_heads_bwd(do: torch.Tensor, p: torch.Tensor, probs: torch.Tensor,
                    dh: int) -> torch.Tensor:
    """``fused_train._attn_heads_bwd``: do [P, n, heads, dh] (bf16 values),
    tokens p [P, n, heads, 3dh], probs from ``_attn_heads_fwd``. Returns
    dqkv [P, n, heads, 3dh] bf16."""
    q, k, v = p[..., :dh], p[..., dh:2 * dh], p[..., 2 * dh:]
    dv = torch.einsum("phnm,pnhd->pmhd", probs, do)
    dp = torch.einsum("pnhd,pmhd->phnm", do, v)
    ssum = (dp * probs).sum(-1, keepdim=True)
    ds = (probs * (dp - ssum) * (dh ** -0.5)).to(torch.bfloat16).float()
    dq = torch.einsum("phnm,pmhd->pnhd", ds, k)
    dk = torch.einsum("phnm,pnhd->pmhd", ds, q)
    return torch.cat([dq, dk, dv], -1).to(torch.bfloat16)


def partition_attention(qkv: torch.Tensor, *, heads: int, dim_head: int,
                        part: Tuple[int, int], window: bool,
                        plain: bool = False) -> torch.Tensor:
    """See ``partition_attention_plain``; one CUDA block per (frame,
    partition, group of up to four heads) with the partition gather in
    its load addressing."""
    if plain or not qkv.is_cuda:
        return partition_attention_plain(qkv, heads, dim_head, part, window)
    N, H, W, C3 = qkv.shape
    ph, pw = part
    C = C3 // 3
    check_operands("partition_attention", qkv)
    need(qkv.dtype == torch.bfloat16 and C == heads * dim_head
         and dim_head in (16, 24, 32, 64) and H % ph == 0 and W % pw == 0
         and ph * pw <= 128,
         "partition_attention: bf16 qkv [N, H, W, 3*heads*dh], dh in "
         "(16, 24, 32, 64), H, W divisible by the partition, <= 128 tokens")
    out = torch.empty((N, H, W, C), dtype=torch.bfloat16, device=qkv.device)
    err = kernels.lib("partition_attention").rvt_partition_attention(
        ptr(qkv), ptr(out), N, H, W, C, dim_head, ph, pw, int(window),
        float(dim_head ** -0.5), stream_ptr(qkv))
    check(err, "partition_attention")
    PARTITION_ATTENTION.launches += 1
    return out


# ---------------------------------------------------------------------------
# Composition: one sub-block, the pair
# ---------------------------------------------------------------------------


def _one_block(R: torch.Tensor, prm: Dict[str, torch.Tensor],
               x_in_bf16: torch.Tensor | None, *, window: bool, heads: int,
               dim_head: int, part: Tuple[int, int], eps: float,
               plain: bool, with_bf16: bool = False):
    """One PartitionAttention sub-block on the f32 residual R [N, H, W, C],
    updated in place. ``x_in_bf16`` set = skip_first_norm: it enters the
    attention unnormalised. With ``with_bf16`` returns (R, bf16(R)), the
    copy written by the last product's epilogue."""
    N, H, W, C = R.shape
    M = N * H * W
    R2 = R.view(M, C)
    xa = (x_in_bf16.reshape(M, C) if x_in_bf16 is not None else
          ln_rows(R2, prm["ln1_s"], prm["ln1_b"], eps, plain=plain))
    qkv = gemm_bf16(xa, prm["qkv_w"], "bias", bias=prm["qkv_b"],
                    plain=plain)
    o = partition_attention(qkv.view(N, H, W, 3 * C), heads=heads,
                            dim_head=dim_head, part=part, window=window,
                            plain=plain)
    gemm_bf16(o.view(M, C), prm["proj_w"], "residual", bias=prm["proj_b"],
              out=R2, plain=plain)
    y = ln_rows(R2, prm["ln2_s"], prm["ln2_b"], eps, plain=plain)
    y = gemm_bf16(y, prm["fc1_w"], "gelu", bias=prm["fc1_b"], plain=plain)
    r = gemm_bf16(y, prm["fc2_w"], "residual", bias=prm["fc2_b"], out=R2,
                  want_aux=with_bf16, plain=plain)
    return (R, r[1].view(R.shape)) if with_bf16 else R


def fused_attention_pair(x: torch.Tensor, params_window: Dict[str, torch.Tensor],
                         params_grid: Dict[str, torch.Tensor], *, heads: int,
                         dim_head: int, part: Tuple[int, int],
                         skip_first_norm: bool, eps: float,
                         ds_ln_params: Sequence[torch.Tensor] = (),
                         ds_eps: float = 1e-5, plain: bool = False,
                         with_bf16: bool = False):
    """Window attention followed by grid attention (one MaxViT block) over
    x [N, H, W, C] (bf16 or f32). Returns the f32 residual stream, with
    ``with_bf16`` also its bf16 copy (R, bf16(R)). ``ds_ln_params`` =
    (scale, bias): x is the raw downsample-conv output and its LayerNorm
    runs first (requires skip_first_norm)."""
    x = x.contiguous()
    if ds_ln_params:
        need(skip_first_norm, "ds_ln_params requires skip_first_norm")
        x_bf16, R = ln_rows(x, ds_ln_params[0], ds_ln_params[1], ds_eps,
                            with_f32=True, plain=plain)
    else:
        x_bf16, R = x.to(torch.bfloat16), x.to(torch.float32, copy=True)
    kw = dict(heads=heads, dim_head=dim_head, part=part, eps=eps,
              plain=plain)
    R = _one_block(R, params_window, x_bf16 if skip_first_norm else None,
                   window=True, **kw)
    return _one_block(R, params_grid, None, window=False, with_bf16=with_bf16,
                      **kw)


def attention_block_params(block, skip_first_norm: bool
                           ) -> Dict[str, torch.Tensor]:
    """One PartitionAttention module's parameters (master f32, upstream
    torch layout) as the kernels take them: weights [in, out] bf16,
    vectors bf16. The LayerScale gammas are folded into the proj/fc2
    weights and biases in f32 before the bf16 cast, as the JAX package's
    ``attention_block_params`` does."""
    bf = torch.bfloat16
    g1 = block.ls1.gamma.detach().float()
    g2 = block.ls2.gamma.detach().float()
    attn, mlp = block.self_attn, block.mlp
    fc1, fc2 = mlp.net[0][0], mlp.net[2]

    def w(lin, g=None):
        m = lin.weight.detach().float().t()
        return (m if g is None else m * g).to(bf).contiguous()

    def v(t, g=None):
        t = t.detach().float()
        return (t if g is None else t * g).to(bf).contiguous()

    out = {}
    if not skip_first_norm:
        out["ln1_s"], out["ln1_b"] = v(block.norm1.weight), v(block.norm1.bias)
    out.update(qkv_w=w(attn.qkv), qkv_b=v(attn.qkv.bias),
               proj_w=w(attn.proj, g1), proj_b=v(attn.proj.bias, g1),
               ln2_s=v(block.norm2.weight), ln2_b=v(block.norm2.bias),
               fc1_w=w(fc1), fc1_b=v(fc1.bias),
               fc2_w=w(fc2, g2), fc2_b=v(fc2.bias, g2))
    return out


# ---------------------------------------------------------------------------
# Training: column sums (train_reduce)
# ---------------------------------------------------------------------------


def _rows_per_block(M: int) -> int:
    """Rows per block of K5's column-sum partials: at most 1024 partial
    rows for ``sum_parts`` to add, at least 64 rows per block."""
    rpb = max(64, -(-M // 1024))
    return -(-rpb // 8) * 8


_RED_THREADS, _RED_UNROLL = 256, 4  # csrc/train_reduce.cu's THREADS, UNROLL
_RED_BLOCKS = 528  # blocks wanted: four an SM of a 132-SM H100 (a constant,
#                    not the card's count, so that the sum order is too)
_RED_FINAL = 32    # partial rows a thread of the finishing block adds at most
_RED_TICKETS = 1024  # > the column tiles of a split sum (< _RED_BLOCKS)
# Per device: (tickets, f32 partials), kept from call to call
_WORKSPACE: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}


class ReducePlan(NamedTuple):
    chunks: int  # row chunks, each summed by its own blocks
    rows: int    # rows a chunk
    vec: int     # columns a thread owns (16 bytes of input where N allows)
    tx: int      # column vectors a block's tile
    ty: int      # row lanes a block

    def blocks(self, N: int) -> int:
        """Blocks of a launch over N columns: column tiles x row chunks."""
        return -(-(N // self.vec) // self.tx) * self.chunks


@functools.lru_cache(maxsize=None)
def reduce_plan(M: int, N: int, itemsize: int = 4) -> ReducePlan:
    """How ``train_reduce`` splits the column sums of an [M, N] array of
    ``itemsize``-byte elements: a function of the shape alone, so the sum
    order is the same on every card. Up to 16 column vectors and 256 // tx
    row lanes a block (fewer lanes where the rows cannot give each
    ``_RED_UNROLL``); the rows in chunks until about ``_RED_BLOCKS``
    blocks, each lane keeping at least two batches of ``_RED_UNROLL`` rows
    and the finishing block at most ``_RED_FINAL`` partials a thread."""
    vec = 16 // itemsize
    while N % vec:
        vec //= 2
    nv = N // vec
    # 8-16 vectors a row (128-256 bytes of f32) across a tile, a divisor of
    # nv where there is one; the rest of the block's 256 threads row lanes
    tx = nv if nv <= 16 else next((d for d in range(16, 7, -1) if nv % d == 0),
                                  16)
    ty = _RED_THREADS // tx
    while ty > 1 and ty * _RED_UNROLL > M:
        ty //= 2
    tx = min(nv, _RED_THREADS // ty)
    tiles = -(-nv // tx)
    chunks = max(1, min(-(-_RED_BLOCKS // tiles), _RED_FINAL * ty,
                        M // (ty * 2 * _RED_UNROLL)))
    rows = -(-M // chunks)
    return ReducePlan(-(-M // rows), rows, vec, tx, ty)


def _reduce_workspace(like: torch.Tensor, floats: int):
    """The device's ``train_reduce`` workspace: the tickets, one int a
    column tile, zeroed once here and reset by each finishing block; and
    room for ``floats`` f32 partials, grown when a call needs more, the
    old partials retired (``kernels.retire``: a captured graph may still
    write them). Kept from call to call: the port launches on one stream,
    and every captured step replays on it, so one launch's partials are
    read before the next launch writes them."""
    dev = like.get_device()
    ws = _WORKSPACE.get(dev)
    if ws is None or ws[1].numel() < floats:
        if ws is not None:
            kernels.retire(ws[1])
        tickets = ws[0] if ws is not None else torch.zeros(
            _RED_TICKETS, dtype=torch.int32, device=like.device)
        ws = _WORKSPACE[dev] = (tickets, torch.empty(
            max(floats, 1 << 16), dtype=torch.float32, device=like.device))
    return ws


def _reduce_launch(name: str, fn: str, args: tuple, plan: ReducePlan,
                   nout: int, like: torch.Tensor) -> None:
    """One ``train_reduce`` launch: ``args`` then the plan, the partials
    (``nout`` result columns a chunk), the tickets and the stream."""
    tickets, part = _reduce_workspace(like, plan.chunks * nout)
    err = getattr(kernels.lib("train_reduce"), fn)(
        *args, *plan, part.data_ptr(), tickets.data_ptr(), stream_ptr(like))
    check(err, name)
    TRAIN_REDUCE.launches += 1


def sum_parts(part: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """part [n, ...] f32 -> its sum over the first axis, in a fixed order
    (the second pass of K2's gelu backward, K5, K6 and K8)."""
    if plain or not part.is_cuda:
        return part.sum(0)
    check_operands("sum_parts", part)
    need(part.dtype == torch.float32 and part.dim() >= 2
         and part.shape[0] > 0, "sum_parts: f32 partials [n > 0, ...]")
    P = part.shape[0]
    N = part.numel() // P
    out = part.new_empty(N)
    _reduce_launch("sum_parts", "rvt_sum_parts",
                   (part.data_ptr(), out.data_ptr(), P, N), reduce_plan(P, N),
                   N, part)
    return out if part.dim() == 2 else out.view(part.shape[1:])


def col_sum(x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """Column sums of x [M, N] (f32 or bf16) in f32: the qkv bias
    gradient (``_block_bwd`` :415 sums the bf16 dqkv)."""
    if plain or not x.is_cuda:
        return x.float().sum(0)
    M, N = x.shape
    check_operands("col_sum", x)
    need(x.dtype in (torch.float32, torch.bfloat16) and M > 0,
         "col_sum: f32/bf16 [M > 0, N]")
    out = x.new_empty(N, dtype=torch.float32)
    _reduce_launch("col_sum", "rvt_colsum",
                   (x.data_ptr(), int(x.dtype == torch.float32),
                    out.data_ptr(), M, N),
                   reduce_plan(M, N, x.element_size()), N, x)
    return out


def layer_scale_bwd_plain(dR: torch.Tensor, v: torch.Tensor,
                          gamma: torch.Tensor):
    d = dR * gamma.reshape(-1)
    return d.to(torch.bfloat16), d.sum(0), (v.float() * dR).sum(0)


def layer_scale_bwd(dR: torch.Tensor, v: torch.Tensor, gamma: torch.Tensor,
                    *, plain: bool = False):
    """Backward of ``R_out = R_in + f32(v) * gamma`` followed by the bias
    add that made v (``_block_bwd`` :369-374, :394-404): dR [M, C] f32, v
    [M, C] bf16, gamma [C] f32. Returns (bf16(dR * gamma) [M, C], the bias
    gradient sum(dR * gamma) [C], the gamma gradient sum(v * dR) [C])."""
    if plain or not dR.is_cuda:
        return layer_scale_bwd_plain(dR, v, gamma)
    M, C = dR.shape
    g = gamma.reshape(-1)
    check_operands("layer_scale_bwd", dR, v, g)
    need(dR.dtype == g.dtype == torch.float32 and v.dtype == torch.bfloat16
         and tuple(v.shape) == (M, C) and g.numel() == C and M > 0,
         "layer_scale_bwd: dR f32 [M > 0, C], v bf16 [M, C], gamma f32 [C]")
    d = torch.empty_like(v)
    sums = dR.new_empty(2 * C)  # the sums of d, then of v * dR
    _reduce_launch("layer_scale_bwd", "rvt_ls_bwd",
                   (dR.data_ptr(), v.data_ptr(), g.data_ptr(), d.data_ptr(),
                    sums.data_ptr(), M, C), reduce_plan(M, C), 2 * C, dR)
    return d, sums[:C], sums[C:]


# ---------------------------------------------------------------------------
# Training: K5 ln_rows_bwd, K6 gemm_bf16_wgrad
# ---------------------------------------------------------------------------


# Values per lane of K5's one-warp rows it is compiled for: every preset
# width (32, 48, 64, 96, 128, 192, 256, 384, 512).
_LN_BWD_VPL = (1, 2, 3, 4, 6, 8, 12, 16)


def ln_rows_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      eps: float):
    """(dx f32, ds, db) of the LayerNorm of x [M, C] with cotangent dy."""
    _, xhat, rstd = _ln_fwd(x.float(), scale, torch.zeros_like(scale), eps)
    return _ln_bwd(dy, xhat, rstd, scale)


def ln_rows_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                eps: float, *, dres: torch.Tensor | None = None,
                plain: bool = False):
    """LayerNorm backward over the rows of x [M, C] (f32 or bf16; the
    statistics are recomputed from it) with the f32 cotangent dy. With
    ``dres`` [M, C] f32 the input gradient is added into it (in place) and
    returned; otherwise it is returned as bf16. Returns (dx, ds [C] f32,
    db [C] f32)."""
    if plain or not x.is_cuda:
        dx, ds, db = ln_rows_bwd_plain(x, dy, scale, eps)
        if dres is None:
            return dx.to(torch.bfloat16), ds, db
        dres += dx
        return dres, ds, db
    M, C = x.shape
    s = scale.reshape(-1)
    check_operands("ln_rows_bwd", x, dy, s)
    need(x.dtype in (torch.float32, torch.bfloat16)
         and dy.dtype == torch.float32 and tuple(dy.shape) == (M, C)
         and s.dtype == torch.bfloat16 and s.numel() == C
         and C % 16 == 0 and 32 <= C <= 512 and -(-C // 32) in _LN_BWD_VPL,
         "ln_rows_bwd: x f32/bf16 [M, C], dy f32 [M, C], scale bf16 [C]; "
         "C in 32..512, a multiple of 16 with ceil(C / 32) in "
         f"{_LN_BWD_VPL}")
    dxb = None
    if dres is not None:
        check_operands("ln_rows_bwd", dres)
        need(dres.dtype == torch.float32 and tuple(dres.shape) == (M, C),
             "ln_rows_bwd: dres f32 [M, C]")
    else:
        dxb = torch.empty((M, C), dtype=torch.bfloat16, device=x.device)
    rpb = _rows_per_block(M)
    part = torch.empty((-(-M // rpb), 2, C), dtype=torch.float32,
                       device=x.device)
    err = kernels.lib("ln_rows_bwd").rvt_ln_rows_bwd(
        ptr(x), int(x.dtype == torch.float32), ptr(dy), ptr(s), float(eps),
        ptr(dres) if dres is not None else None,
        ptr(dxb) if dxb is not None else None, ptr(part), M, C, rpb,
        stream_ptr(x))
    check(err, "ln_rows_bwd")
    LN_ROWS_BWD.launches += 1
    sums = sum_parts(part)
    return (dres if dres is not None else dxb), sums[0], sums[1]


def wgrad_tile(Ka: int, Nb: int) -> Tuple[int, int]:
    """K6's output tile (rows of Ka, columns of Nb), as
    ``csrc/gemm_bf16_wgrad.cu`` picks it."""
    return (64 if Ka <= 64 else 128), (64 if Nb <= 64 else
                                       128 if Nb <= 128 else 256)


def wgrad_splits(M: int, Ka: int, Nb: int, sms: int) -> Tuple[int, int]:
    """(splits, rows per split) of K6: at most one (split, tile) unit per
    SM, as many as fill them, each split whole 64-row k-tiles."""
    bm, bn = wgrad_tile(Ka, Nb)
    tiles = -(-Ka // bm) * -(-Nb // bn)
    splits = max(1, min(sms // tiles, -(-M // 64)))
    rps = -(-(-(-M // splits)) // 64) * 64
    return -(-M // rps), rps


def gemm_bf16_wgrad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float().t() @ b.float()


def gemm_bf16_wgrad(a: torch.Tensor, b: torch.Tensor, *,
                    plain: bool = False) -> torch.Tensor:
    """a^T . b over the rows of a [M, Ka] and b [M, Nb] (bf16) -> f32
    [Ka, Nb]: every weight gradient (``_dot_t``). The rows are split over
    blocks, the splits summed in order by ``sum_parts``."""
    if plain or not a.is_cuda:
        return gemm_bf16_wgrad_plain(a, b)
    M, Ka = a.shape
    Nb = b.shape[1]
    check_operands("gemm_bf16_wgrad", a, b)
    need(a.dtype == b.dtype == torch.bfloat16 and b.shape[0] == M
         and Ka % 8 == 0 and Nb % 8 == 0,
         "gemm_bf16_wgrad: bf16 a [M, Ka], b [M, Nb]; Ka, Nb multiples of 8")
    splits, rps = wgrad_splits(M, Ka, Nb, sm_count(a))
    part = torch.empty((splits, Ka, Nb), dtype=torch.float32,
                       device=a.device)
    err = kernels.lib("gemm_bf16_wgrad").rvt_gemm_bf16_wgrad(
        ptr(a), ptr(b), ptr(part), M, Ka, Nb, splits, rps, stream_ptr(a))
    check(err, "gemm_bf16_wgrad")
    GEMM_BF16_WGRAD.launches += 1
    return part[0] if splits == 1 else sum_parts(part)


# ---------------------------------------------------------------------------
# Training: K7 partition_attention_bwd
# ---------------------------------------------------------------------------


def partition_attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor,
                                  heads: int, dim_head: int,
                                  part: Tuple[int, int],
                                  window: bool) -> torch.Tensor:
    """dqkv [N, H, W, 3C] bf16 of ``partition_attention`` for the bf16
    cotangent do [N, H, W, C] of its output: the probabilities recomputed,
    then ``_attn_heads_bwd``."""
    N, H, W, C3 = qkv.shape
    n = part[0] * part[1]
    p = _partitions(qkv, part, window).reshape(-1, n, heads,
                                               3 * dim_head).float()
    _, probs = _attn_heads_fwd(p, dim_head)
    d = _partitions(do, part, window).reshape(-1, n, heads,
                                              dim_head).float()
    dqkv = _attn_heads_bwd(d, p, probs, dim_head)
    return _unpartitions(dqkv.reshape(-1, n, C3), (N, H, W, C3), part,
                         window)


def partition_attention_bwd(qkv: torch.Tensor, do: torch.Tensor, *,
                            heads: int, dim_head: int, part: Tuple[int, int],
                            window: bool, plain: bool = False
                            ) -> torch.Tensor:
    """See ``partition_attention_bwd_plain``; one CUDA block per (frame,
    partition, group of heads) with K3's partition addressing and softmax
    (dh 16, 24, 32, 64; up to 128 tokens)."""
    if plain or not qkv.is_cuda:
        return partition_attention_bwd_plain(qkv, do, heads, dim_head, part,
                                             window)
    N, H, W, C3 = qkv.shape
    ph, pw = part
    C = C3 // 3
    check_operands("partition_attention_bwd", qkv, do)
    need(qkv.dtype == do.dtype == torch.bfloat16 and C == heads * dim_head
         and tuple(do.shape) == (N, H, W, C)
         and dim_head in (16, 24, 32, 64) and H % ph == 0 and W % pw == 0
         and ph * pw <= 128,
         "partition_attention_bwd: bf16 qkv [N, H, W, 3*heads*dh], do "
         "[N, H, W, heads*dh], dh in (16, 24, 32, 64), H, W divisible by "
         "the partition, <= 128 tokens")
    dqkv = torch.empty_like(qkv)
    err = kernels.lib("partition_attention_bwd").rvt_partition_attention_bwd(
        ptr(qkv), ptr(do), ptr(dqkv), N, H, W, C, dim_head, ph, pw,
        int(window), float(dim_head ** -0.5), stream_ptr(qkv))
    check(err, "partition_attention_bwd")
    PARTITION_ATTENTION_BWD.launches += 1
    return dqkv
