"""Parameter containers of the MaxViT-RNN backbone blocks.

Port of the modules in ``rvt_tpu/models/layers.py``. The port names its
parameters as the upstream PyTorch RVT module tree does
(``maxvit.py`` / ``rnn.py``), so an upstream checkpoint loads with
``load_state_dict`` and the weight bridge (``convert/from_flax.py``) is
the inverse of the JAX package's ``convert_state_dict``.

The serving path computes these blocks with the hand-written kernels
(``ops/fused_attention.py``, ``ops/fused_scan.py``), so the containers
here hold parameters only. The erf-gelu module forward the JAX package
keeps for training comes with the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from rvt_tpu_torch.config import (AttentionConfig, DownsampleConfig,
                                  LstmConfig)


class LayerScale(nn.Module):
    """Per-channel residual scale (maxvit.py LayerScale): ``gamma [dim]``."""

    def __init__(self, dim: int, init_value: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))


class SelfAttentionCl(nn.Module):
    """Channels-last MHSA parameters: ``qkv`` (per-head interleaved
    q | k | v of dim_head each) and ``proj``."""

    def __init__(self, dim: int, bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=bias)
        self.proj = nn.Linear(dim, dim, bias=bias)


class MLP(nn.Module):
    """Plain (non-gated) FFN: ``net.0.0`` = fc1, ``net.2`` = fc2."""

    def __init__(self, dim: int, expansion_ratio: int, bias: bool = True):
        super().__init__()
        inner = int(dim * expansion_ratio)
        self.net = nn.Sequential(
            nn.Sequential(nn.Linear(dim, inner, bias=bias), nn.GELU()),
            nn.Identity(),
            nn.Linear(inner, dim, bias=bias))


class PartitionAttention(nn.Module):
    """LN -> window/grid attention -> LS -> residual; LN -> MLP -> LS ->
    residual (maxvit.py:185-270). ``norm1`` is absent with
    ``skip_first_norm``."""

    def __init__(self, dim: int, cfg: AttentionConfig,
                 skip_first_norm: bool = False):
        super().__init__()
        if (cfg.mlp_gated or not cfg.attention_bias or not cfg.mlp_bias
                or cfg.ls_init_value <= 0):
            raise NotImplementedError(
                "the port serves the shipped block variant: plain MLP, "
                "biases, LayerScale")
        if not skip_first_norm:
            self.norm1 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.self_attn = SelfAttentionCl(dim, cfg.attention_bias)
        self.ls1 = LayerScale(dim, cfg.ls_init_value)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.mlp = MLP(dim, cfg.mlp_ratio, cfg.mlp_bias)
        self.ls2 = LayerScale(dim, cfg.ls_init_value)


class MaxVitAttentionPair(nn.Module):
    """Window attention then grid attention (maxvit_rnn.py:108-127)."""

    def __init__(self, dim: int, cfg: AttentionConfig,
                 skip_first_norm: bool):
        super().__init__()
        self.att_window = PartitionAttention(dim, cfg, skip_first_norm)
        self.att_grid = PartitionAttention(dim, cfg, False)


class ConvDownsample(nn.Module):
    """Strided conv (no bias) + LayerNorm: upstream
    ``ConvDownsampling_Cf2Cl``. The stem's stored kernel is the 7x7 one
    even when the input arrives s2d-blocked; ``detector.downsample_conv_apply``
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


class DWSConvLSTM2d(nn.Module):
    """ConvLSTM cell parameters (rnn.py): ``conv1x1`` maps [x, h] (2C) to
    the gates (forget, input, output, cell-update), 4C."""

    def __init__(self, dim: int, cfg: LstmConfig):
        super().__init__()
        if cfg.dws_conv or cfg.drop_cell_update > 0:
            raise NotImplementedError(
                "the port serves the shipped LSTM variant (no dws conv)")
        self.conv1x1 = nn.Conv2d(2 * dim, 4 * dim, 1)
