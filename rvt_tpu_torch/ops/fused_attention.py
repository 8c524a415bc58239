"""MaxViT attention pair on hand-written Hopper kernels.

Port of ``rvt_tpu/ops/fused_attention.py``. On the TPU one Pallas kernel
per image (``_blocks_kernel`` / ``_one_block``) runs a whole
PartitionAttention sub-block with every intermediate in VMEM. The pair
has no recurrence in time, so here it runs over all T*B frames at once as
a chain of three kernels (``csrc/``):

  K1 ``ln_rows``             LayerNorm rows (ds-LN, LN1, LN2)
  K2 ``gemm_bf16``           qkv / proj / fc1 / fc2 with fused epilogues
  K3 ``partition_attention`` per-(frame, partition, head) softmax attention

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
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops.kernels import (Counter, check, check_operands, need,
                                       ptr, stream_ptr)

LN_ROWS = Counter("ln_rows")
GEMM_BF16 = Counter("gemm_bf16")
PARTITION_ATTENTION = Counter("partition_attention")

EPILOGUES = {"bias": 0, "gelu": 1, "residual": 2}


# ---------------------------------------------------------------------------
# K1 ln_rows
# ---------------------------------------------------------------------------


def ln_rows_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """flax LayerNorm as the JAX kernel computes it (``_layer_norm_f32``):
    f32 stats with the fast variance, affine in f32, bf16 result."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float().reshape(-1) + bias.float().reshape(-1)
    return y.to(torch.bfloat16)


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
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    yf = torch.empty(x.shape, dtype=torch.float32,
                     device=x.device) if with_f32 else None
    M = x.numel() // C
    err = kernels.lib("ln_rows").rvt_ln_rows(
        ptr(x), int(x.dtype == torch.float32), ptr(s), ptr(b), ptr(y),
        ptr(yf) if yf is not None else None, M, C, float(eps),
        stream_ptr(x))
    check(err, "ln_rows")
    LN_ROWS.launches += 1
    return (y, yf) if with_f32 else y


# ---------------------------------------------------------------------------
# K2 gemm_bf16
# ---------------------------------------------------------------------------


def _gelu_tanh(xf: torch.Tensor) -> torch.Tensor:
    """The JAX kernel's tanh-gelu (``fused_attention._gelu``), in f32."""
    inner = 0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)
    return 0.5 * xf * (1.0 + torch.tanh(inner))


def gemm_bf16_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    epilogue: str, residual: torch.Tensor | None = None):
    out = (a.float() @ w.float()).to(torch.bfloat16)
    out = (out.float() + bias.float().reshape(-1)).to(torch.bfloat16)
    if epilogue == "gelu":
        return _gelu_tanh(out.float()).to(torch.bfloat16)
    if epilogue == "residual":
        residual += out.float()
        return residual
    return out


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              epilogue: str, residual: torch.Tensor | None = None, *,
              plain: bool = False) -> torch.Tensor:
    """``a [M, K] bf16 @ w [K, N] bf16`` with f32 accumulation, rounded to
    bf16, plus the bf16 ``bias [N]``; then ``epilogue``:

      "bias"      return the bf16 [M, N] result
      "gelu"      return tanh-gelu of it, bf16
      "residual"  ``residual [M, N] f32 += result`` in place; returns it
    """
    need(epilogue in EPILOGUES, f"gemm_bf16: unknown epilogue {epilogue}")
    need((residual is not None) == (epilogue == "residual"),
         "gemm_bf16: pass residual exactly for the residual epilogue")
    if plain or not a.is_cuda:
        return gemm_bf16_plain(a, w, bias, epilogue, residual)
    M, K = a.shape
    N = w.shape[1]
    b = bias.reshape(-1)
    check_operands("gemm_bf16", a, w, b)
    need(a.dtype == w.dtype == b.dtype == torch.bfloat16
         and w.shape[0] == K and b.numel() == N and K % 8 == 0
         and N % 8 == 0, "gemm_bf16: bf16 a [M, K], w [K, N], bias [N]; "
         "K and N multiples of 8")
    if epilogue == "residual":
        check_operands("gemm_bf16", residual)
        need(residual.dtype == torch.float32
             and tuple(residual.shape) == (M, N),
             "gemm_bf16: residual must be f32 [M, N]")
        out = residual
    else:
        out = torch.empty((M, N), dtype=torch.bfloat16, device=a.device)
    err = kernels.lib("gemm_bf16").rvt_gemm_bf16(
        ptr(a), ptr(w), ptr(b), ptr(out), M, N, K, EPILOGUES[epilogue],
        stream_ptr(a))
    check(err, "gemm_bf16")
    GEMM_BF16.launches += 1
    return out


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
    C, dh = C3 // 3, dim_head
    ph, pw = part
    nh, nw = H // ph, W // pw
    if window:
        p = qkv.reshape(N, nh, ph, nw, pw, C3).permute(0, 1, 3, 2, 4, 5)
    else:
        p = qkv.reshape(N, ph, nh, pw, nw, C3).permute(0, 2, 4, 1, 3, 5)
    p = p.reshape(N * nh * nw, ph * pw, heads, 3 * dh).float()
    q, k, v = p[..., :dh], p[..., dh:2 * dh], p[..., 2 * dh:]
    s = torch.einsum("pnhd,pmhd->phnm", q, k)
    probs = torch.softmax(s * (dh ** -0.5), dim=-1)
    probs = probs.to(torch.bfloat16).float()
    o = torch.einsum("phnm,pmhd->pnhd", probs, v).to(torch.bfloat16)
    o = o.reshape(N, nh, nw, ph, pw, C)
    if window:
        o = o.permute(0, 1, 3, 2, 4, 5)
    else:
        o = o.permute(0, 3, 1, 4, 2, 5)
    return o.reshape(N, H, W, C)


def partition_attention(qkv: torch.Tensor, *, heads: int, dim_head: int,
                        part: Tuple[int, int], window: bool,
                        plain: bool = False) -> torch.Tensor:
    """See ``partition_attention_plain``; one CUDA block per (frame,
    partition, head) with the partition gather in its load addressing."""
    if plain or not qkv.is_cuda:
        return partition_attention_plain(qkv, heads, dim_head, part, window)
    N, H, W, C3 = qkv.shape
    ph, pw = part
    C = C3 // 3
    check_operands("partition_attention", qkv)
    need(qkv.dtype == torch.bfloat16 and C == heads * dim_head
         and dim_head in (16, 32, 64) and H % ph == 0 and W % pw == 0
         and ph * pw <= 128,
         "partition_attention: bf16 qkv [N, H, W, 3*heads*dh], dh in "
         "(16, 32, 64), H, W divisible by the partition, <= 128 tokens")
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
               plain: bool) -> torch.Tensor:
    """One PartitionAttention sub-block on the f32 residual R [N, H, W, C],
    updated in place. ``x_in_bf16`` set = skip_first_norm: it enters the
    attention unnormalised."""
    N, H, W, C = R.shape
    M = N * H * W
    R2 = R.view(M, C)
    xa = (x_in_bf16.reshape(M, C) if x_in_bf16 is not None else
          ln_rows(R2, prm["ln1_s"], prm["ln1_b"], eps, plain=plain))
    qkv = gemm_bf16(xa, prm["qkv_w"], prm["qkv_b"], "bias", plain=plain)
    o = partition_attention(qkv.view(N, H, W, 3 * C), heads=heads,
                            dim_head=dim_head, part=part, window=window,
                            plain=plain)
    gemm_bf16(o.view(M, C), prm["proj_w"], prm["proj_b"], "residual", R2,
              plain=plain)
    y = ln_rows(R2, prm["ln2_s"], prm["ln2_b"], eps, plain=plain)
    y = gemm_bf16(y, prm["fc1_w"], prm["fc1_b"], "gelu", plain=plain)
    gemm_bf16(y, prm["fc2_w"], prm["fc2_b"], "residual", R2, plain=plain)
    return R


def fused_attention_pair(x: torch.Tensor, params_window: Dict[str, torch.Tensor],
                         params_grid: Dict[str, torch.Tensor], *, heads: int,
                         dim_head: int, part: Tuple[int, int],
                         skip_first_norm: bool, eps: float,
                         ds_ln_params: Sequence[torch.Tensor] = (),
                         ds_eps: float = 1e-5,
                         plain: bool = False) -> torch.Tensor:
    """Window attention followed by grid attention (one MaxViT block) over
    x [N, H, W, C] (bf16 or f32). Returns the f32 residual stream.
    ``ds_ln_params`` = (scale, bias): x is the raw downsample-conv output
    and its LayerNorm runs first (requires skip_first_norm)."""
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
    return _one_block(R, params_grid, None, window=False, **kw)


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
