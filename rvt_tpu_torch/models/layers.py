"""The MaxViT-RNN backbone blocks: parameters and the module forwards.

Port of ``rvt_tpu/models/layers.py``. The port names its parameters as
the upstream PyTorch RVT module tree does (``maxvit.py`` / ``rnn.py``),
so an upstream checkpoint loads with ``load_state_dict`` and the weight
bridge (``convert/from_flax.py``) is the inverse of the JAX package's
``convert_state_dict``.

The forwards are the JAX package's XLA module path, the path it runs for
every config and stage its kernels do not take (the shipped presets
among them). They copy flax's dtype threading: parameters stay f32;
``Dense`` and ``Conv`` compute in the compute dtype (``dtype``: float32
or bfloat16), the bias added before the result's one rounding as XLA
fuses it; ``LayerNorm`` takes its
statistics in f32 and writes the compute dtype; the attention einsums
accumulate in f32; LayerScale multiplies by its f32 gamma, so in bf16 the
residual stream turns f32 after the first one (JAX's type promotion,
which torch shares); the ConvLSTM's gates run in the compute dtype and
its cell in f32. Autograd gives the backward.

Serving (``deterministic``) with ``fused_kernels`` and bf16, the JAX
modules run their kernels where those take the block: an attention pair
of the shipped variant (``attention_variant_shipped``) at a geometry in
the envelope goes to K1-K3 (``ops/fused_attention.fused_attention_pair``),
a cell of the shipped variant to K4 at T = 1 (``ops/fused_scan.
fused_conv_lstm``); these modules do the same.

Dropout (drop-path, MLP dropout, cell-update dropout) draws from an
explicit ``torch.Generator``; without one a rate above 0 raises, as flax
raises without a 'dropout' rng. The JAX train step passes none.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rvt_tpu_torch.config import (AttentionConfig, DownsampleConfig,
                                  LstmConfig)
from rvt_tpu_torch.ops.fused_attention import (attention_block_params,
                                               fused_attention_pair,
                                               pair_fusion_ok)
from rvt_tpu_torch.ops.fused_scan import fused_conv_lstm
from rvt_tpu_torch.ops.s2d import BLOCK, fold_stem_kernel

Gen = Optional[torch.Generator]


def attention_variant_shipped(a: AttentionConfig) -> bool:
    """The attention block the kernels compute: the plain tanh-gelu MLP
    with biases, LayerScale > 0, no drop-path or MLP dropout."""
    return (not a.mlp_gated and a.attention_bias and a.mlp_bias
            and a.ls_init_value > 0 and a.drop_path == 0.0
            and a.drop_mlp == 0.0 and a.mlp_activation == "gelu")


def lstm_variant_shipped(cfg: LstmConfig) -> bool:
    """The ConvLSTM cell K4 computes: 1x1, no cell-update dropout."""
    return not cfg.dws_conv and cfg.drop_cell_update == 0.0


def _act(name: str):
    if name == "gelu":
        return F.gelu  # the exact erf form
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    raise NotImplementedError(name)


def _cast(p: torch.Tensor | None, dtype: torch.dtype):
    return None if p is None else p.to(dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype
          ) -> torch.Tensor:
    """flax ``Dense``: operands and result in ``dtype``; the bias is added
    to the f32 accumulator before the one rounding, as XLA fuses it."""
    return F.linear(x.to(dtype), lin.weight.to(dtype), _cast(lin.bias, dtype))


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype
              ) -> torch.Tensor:
    """flax ``Conv`` on NHWC ``x`` with the module's stride, padding and
    groups: operands and result in ``dtype``, the bias added before the
    rounding."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype),
                 _cast(conv.bias, dtype), conv.stride, conv.padding, 1,
                 conv.groups)
    return y.permute(0, 2, 3, 1)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    """flax ``LayerNorm`` over the last axis: f32 statistics (the fast
    variance, clamped at 0), ``(x - mu) * (rsqrt(var + eps) * scale) +
    bias`` in f32, written in ``dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + norm.eps)
    if norm.weight is not None:
        mul = mul * norm.weight
    y = (xf - mu) * mul
    if norm.bias is not None:
        y = y + norm.bias
    return y.to(dtype)


def _need_gen(gen: Gen, what: str, rate: float) -> None:
    if gen is None:
        raise RuntimeError(
            f"{what} with rate {rate} needs a torch.Generator when not "
            "deterministic (the JAX package's module raises without a "
            "'dropout' rng, and its train step passes none)")


def dropout(x: torch.Tensor, rate: float, deterministic: bool, gen: Gen,
            what: str = "dropout") -> torch.Tensor:
    """flax ``Dropout``: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), from ``gen``."""
    if rate == 0.0 or deterministic:
        return x
    _need_gen(gen, what, rate)
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, deterministic: bool,
              gen: Gen) -> torch.Tensor:
    """Stochastic depth per sample (``rvt_tpu/models/layers.py:DropPath``):
    each sample's branch kept with probability 1 - rate, scaled by
    1 / (1 - rate)."""
    if rate == 0.0 or deterministic:
        return x
    _need_gen(gen, "drop-path", rate)
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    return x * mask / keep


# ---------------------------------------------------------------------------
# Partitioning (maxvit.py:273-304), NHWC
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/wh * W/ww, wh*ww, C]."""
    B, H, W, C = x.shape
    wh, ww = ws
    x = x.reshape(B, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, wh * ww, C)


def window_reverse(win: torch.Tensor, ws: Tuple[int, int],
                   img: Tuple[int, int]) -> torch.Tensor:
    (H, W), (wh, ww) = img, ws
    x = win.reshape(-1, H // wh, W // ww, wh, ww, win.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, H, W, win.shape[-1])


def grid_partition(x: torch.Tensor, gs: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B * H/gh * W/gw, gh*gw, C] (dilated grid)."""
    B, H, W, C = x.shape
    gh, gw = gs
    x = x.reshape(B, gh, H // gh, gw, W // gw, C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(-1, gh * gw, C)


def grid_reverse(win: torch.Tensor, gs: Tuple[int, int],
                 img: Tuple[int, int]) -> torch.Tensor:
    (H, W), (gh, gw) = img, gs
    x = win.reshape(-1, H // gh, W // gw, gh, gw, win.shape[-1])
    return x.permute(0, 3, 1, 4, 2, 5).reshape(-1, H, W, win.shape[-1])


# ---------------------------------------------------------------------------
# Attention / MLP / LayerScale
# ---------------------------------------------------------------------------


class LayerScale(nn.Module):
    """Per-channel residual scale (maxvit.py LayerScale): ``gamma [dim]``."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class SelfAttentionCl(nn.Module):
    """Channels-last MHSA: ``qkv`` (per-head interleaved q | k | v of
    dim_head each) and ``proj``."""

    def __init__(self, dim: int, dim_head: int = 32, bias: bool = True):
        super().__init__()
        self.dim_head = dim_head
        self.qkv = nn.Linear(dim, 3 * dim, bias=bias)
        self.proj = nn.Linear(dim, dim, bias=bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x [B, N, C]: scores and softmax in f32, the probabilities cast
        to the compute dtype, both products accumulated in f32."""
        B, N, C = x.shape
        dh = self.dim_head
        qkv = dense(self.qkv, x, dtype).reshape(B, N, C // dh, 3 * dh)
        q, k, v = qkv.split(dh, dim=-1)
        attn = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        attn = torch.softmax(attn * dh ** -0.5, dim=-1).to(q.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float())
        return dense(self.proj, out.to(qkv.dtype).reshape(B, N, C), dtype)


class GLU(nn.Module):
    """Gated linear unit (maxvit.py:56-82): ``proj`` to 2 * dim_out, the
    value half times the activation of the gate half."""

    def __init__(self, dim_in: int, dim_out: int, act: str,
                 bias: bool = True):
        super().__init__()
        self.act = act
        self.proj = nn.Linear(dim_in, 2 * dim_out, bias=bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        val, gate = dense(self.proj, x, dtype).chunk(2, dim=-1)
        return val * _act(self.act)(gate)


class MLP(nn.Module):
    """Transformer FFN, optionally gated (maxvit.py:85-118): plain
    ``net.0.0`` = fc1, gated ``net.0.proj`` (the GLU, inner width
    floor(inner * 2/3 / 32) * 32); ``net.2`` = fc2."""

    def __init__(self, dim: int, expansion_ratio: int, act: str = "gelu",
                 gated: bool = False, bias: bool = True,
                 drop_prob: float = 0.0):
        super().__init__()
        inner = int(dim * expansion_ratio)
        self.act, self.gated, self.drop_prob = act, gated, drop_prob
        if gated:
            inner = math.floor(inner * 2 / 3 / 32) * 32
            first = GLU(dim, inner, act, bias)
        else:
            first = nn.Sequential(nn.Linear(dim, inner, bias=bias))
        self.net = nn.Sequential(first, nn.Identity(),
                                 nn.Linear(inner, dim, bias=bias))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                deterministic: bool = True, gen: Gen = None) -> torch.Tensor:
        if self.gated:
            x = self.net[0](x, dtype)
        else:
            x = _act(self.act)(dense(self.net[0][0], x, dtype))
        x = dropout(x, self.drop_prob, deterministic, gen, "MLP dropout")
        return dense(self.net[2], x, dtype)


class PartitionAttention(nn.Module):
    """LN -> window/grid attention -> LS -> drop-path -> residual; LN ->
    MLP -> LS -> drop-path -> residual (maxvit.py:185-270). ``norm1`` is
    absent with ``skip_first_norm``, ``ls1``/``ls2`` with
    ``ls_init_value`` 0."""

    def __init__(self, dim: int, cfg: AttentionConfig, window: bool,
                 skip_first_norm: bool = False):
        super().__init__()
        self.cfg, self.window = cfg, window
        self.skip_first_norm = skip_first_norm
        if not skip_first_norm:
            self.norm1 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.self_attn = SelfAttentionCl(dim, cfg.dim_head,
                                         cfg.attention_bias)
        if cfg.ls_init_value > 0:
            self.ls1 = LayerScale(dim, cfg.ls_init_value)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.mlp = MLP(dim, cfg.mlp_ratio, cfg.mlp_activation, cfg.mlp_gated,
                       cfg.mlp_bias, cfg.drop_mlp)
        if cfg.ls_init_value > 0:
            self.ls2 = LayerScale(dim, cfg.ls_init_value)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                deterministic: bool = True, gen: Gen = None) -> torch.Tensor:
        cfg = self.cfg
        P = tuple(cfg.partition_size)
        img = tuple(x.shape[1:3])
        shortcut = x
        if not self.skip_first_norm:
            x = layer_norm(self.norm1, x, dtype)
        if self.window:
            x = window_reverse(self.self_attn(window_partition(x, P), dtype),
                               P, img)
        else:
            x = grid_reverse(self.self_attn(grid_partition(x, P), dtype), P,
                             img)
        if cfg.ls_init_value > 0:
            x = self.ls1(x)
        x = shortcut + drop_path(x, cfg.drop_path, deterministic, gen)
        y = self.mlp(layer_norm(self.norm2, x, dtype), dtype, deterministic,
                     gen)
        if cfg.ls_init_value > 0:
            y = self.ls2(y)
        return x + drop_path(y, cfg.drop_path, deterministic, gen)


class MaxVitAttentionPair(nn.Module):
    """Window attention then grid attention (maxvit_rnn.py:108-127)."""

    def __init__(self, dim: int, cfg: AttentionConfig,
                 skip_first_norm: bool):
        super().__init__()
        self.cfg, self.skip_first_norm = cfg, skip_first_norm
        self.att_window = PartitionAttention(dim, cfg, True, skip_first_norm)
        self.att_grid = PartitionAttention(dim, cfg, False, False)

    def kernels_take(self, x: torch.Tensor, kernels: bool) -> bool:
        """Whether the JAX module runs this pair on its kernel
        (``MaxVitAttentionPair._fused_mode``): ``kernels`` (serving a
        ``fused_kernels`` config in bf16), the shipped variant, and the
        geometry in the envelope."""
        cfg = self.cfg
        return (kernels and attention_variant_shipped(cfg)
                and pair_fusion_ok(x.shape[1], x.shape[2], x.shape[3],
                                   tuple(cfg.partition_size)))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                deterministic: bool = True, gen: Gen = None, *,
                kernels: bool = False, plain: bool = False) -> torch.Tensor:
        if self.kernels_take(x, kernels):
            cfg = self.cfg
            return fused_attention_pair(
                x, attention_block_params(self.att_window,
                                          self.skip_first_norm),
                attention_block_params(self.att_grid, False),
                heads=x.shape[-1] // cfg.dim_head, dim_head=cfg.dim_head,
                part=tuple(cfg.partition_size),
                skip_first_norm=self.skip_first_norm, eps=cfg.norm_eps,
                plain=plain)
        x = self.att_window(x, dtype, deterministic, gen)
        return self.att_grid(x, dtype, deterministic, gen)


class ConvDownsample(nn.Module):
    """Strided conv (no bias) + LayerNorm: upstream
    ``ConvDownsampling_Cf2Cl``, NHWC in and out. The stem's stored kernel
    is the 7x7 one even when the input arrives s2d-blocked; ``conv_apply``
    folds it (``ops/s2d.fold_stem_kernel``)."""

    def __init__(self, dim_in: int, dim_out: int, downsample_factor: int,
                 cfg: DownsampleConfig):
        super().__init__()
        f = downsample_factor
        k = (f - 1) * 2 + 1 if cfg.overlap else f
        self.conv = nn.Conv2d(dim_in, dim_out, k, stride=f,
                              padding=k // 2 if cfg.overlap else 0,
                              bias=False)
        self.norm = nn.LayerNorm(dim_out, eps=cfg.norm_eps,
                                 elementwise_affine=cfg.norm_affine)

    def conv_apply(self, x: torch.Tensor, dtype: torch.dtype,
                   s2d: bool = False) -> torch.Tensor:
        """The conv alone on NHWC ``x`` (uint8 or float): operands in
        ``dtype``, NHWC out. ``s2d``: x is 4x4 space-to-depth blocked and
        the 7x7/4 kernel runs folded to its 2x2/1 equivalent."""
        w = self.conv.weight
        if s2d:
            assert self.conv.stride == (BLOCK, BLOCK), "s2d folds the k7/s4 stem"
            w = fold_stem_kernel(w.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
            stride, pad = 1, 0
        else:
            stride, pad = self.conv.stride, self.conv.padding
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype), None,
                     stride, pad)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                s2d: bool = False) -> torch.Tensor:
        return layer_norm(self.norm, self.conv_apply(x, dtype, s2d), dtype)


class DWSConvLSTM2d(nn.Module):
    """ConvLSTM cell (rnn.py): ``conv1x1`` maps [x, h] (2C) to the gates
    (forget, input, output, cell-update), 4C; with ``dws_conv`` a
    depthwise ``conv3x3_dws`` first, over h alone
    (``dws_conv_only_hidden``) or over [x, h]."""

    def __init__(self, dim: int, cfg: LstmConfig):
        super().__init__()
        self.cfg, self.dim = cfg, dim
        if cfg.dws_conv:
            n = dim if cfg.dws_conv_only_hidden else 2 * dim
            k = cfg.dws_conv_kernel_size
            self.conv3x3_dws = nn.Conv2d(n, n, k, padding=k // 2, groups=n)
        self.conv1x1 = nn.Conv2d(2 * dim, 4 * dim, 1)

    def forward(self, x: torch.Tensor, h_c: Tuple[torch.Tensor, torch.Tensor],
                dtype: torch.dtype, deterministic: bool = True,
                gen: Gen = None, *, kernels: bool = False,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step: (h_t, c_t), both f32. With ``kernels`` (serving a
        ``fused_kernels`` config in bf16) the shipped cell runs on K4 at
        T = 1, as the JAX module runs ``fused_conv_lstm``."""
        cfg, C = self.cfg, self.dim
        h, c = h_c
        if kernels and lstm_variant_shipped(cfg):
            conv = self.conv1x1
            return fused_conv_lstm(
                x, h, c, conv.weight[:, :, 0, 0].t().to(torch.bfloat16),
                conv.bias.to(torch.bfloat16), plain=plain)
        if cfg.dws_conv and cfg.dws_conv_only_hidden:
            h = conv_nhwc(self.conv3x3_dws, h, dtype)
        xh = torch.cat([x, h.to(x.dtype)], dim=-1)
        if cfg.dws_conv and not cfg.dws_conv_only_hidden:
            xh = conv_nhwc(self.conv3x3_dws, xh, dtype)
        mix = conv_nhwc(self.conv1x1, xh, dtype)
        gates = torch.sigmoid(mix[..., :3 * C]).float()
        cell = torch.tanh(mix[..., 3 * C:]).float()
        cell = dropout(cell, cfg.drop_cell_update, deterministic, gen,
                       "cell-update dropout")
        c_t = gates[..., :C] * c.float() + gates[..., C:2 * C] * cell
        return gates[..., 2 * C:] * torch.tanh(c_t), c_t
