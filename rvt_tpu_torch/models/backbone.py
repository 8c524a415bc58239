"""Recurrent MaxViT backbone ("MaxViTRNN") parameters and states.

Port of ``rvt_tpu/models/backbone.py``: 4 stages, each a strided-conv
downsample, one window+grid attention pair and a 1x1 ConvLSTM; the
stage's hidden state is both its output and the FPN's skip feature. The
serving computation over a whole window is
``models/detector.py:fused_scan_backbone``.

Parameter names follow upstream ``maxvit_rnn.py``
(``stages.{i}.downsample_cf2cl``, ``stages.{i}.att_blocks.{j}``,
``stages.{i}.lstm``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.config import BackboneConfig
from rvt_tpu_torch.models.layers import (ConvDownsample, DWSConvLSTM2d,
                                         MaxVitAttentionPair)

LstmState = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B, H, W, C]
LstmStates = Tuple[LstmState, ...]


class RVTStage(nn.Module):
    """One backbone stage (maxvit_rnn.py:130-182)."""

    def __init__(self, dim_in: int, dim_out: int, downsample_factor: int,
                 num_blocks: int, enable_token_masking: bool,
                 cfg: BackboneConfig):
        super().__init__()
        self.downsample_cf2cl = ConvDownsample(dim_in, dim_out,
                                               downsample_factor,
                                               cfg.downsample)
        if enable_token_masking:
            self.mask_token = nn.Parameter(torch.zeros(1, 1, 1, dim_out))
        # the first block skips norm1: the downsample output is normed
        self.att_blocks = nn.ModuleList(
            MaxVitAttentionPair(dim_out, cfg.attention, i == 0)
            for i in range(num_blocks))
        self.lstm = DWSConvLSTM2d(dim_out, cfg.lstm)


class RVTBackbone(nn.Module):
    """The 4-stage recurrent backbone's parameters."""

    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        assert cfg.num_stages == 4, "reference asserts 4 stages"
        self.cfg = cfg
        dims = cfg.stage_dims
        self.stages = nn.ModuleList(
            RVTStage(dim_in=cfg.input_channels if i == 0 else dims[i - 1],
                     dim_out=dims[i],
                     downsample_factor=cfg.stem_patch_size if i == 0 else 2,
                     num_blocks=cfg.num_blocks[i],
                     enable_token_masking=cfg.enable_masking and i == 0,
                     cfg=cfg)
            for i in range(cfg.num_stages))


def zero_states(cfg: BackboneConfig, batch_size: int, device="cuda",
                dtype=torch.float32) -> LstmStates:
    """Zero (h, c) per stage, each [B, H/stride, W/stride, C]."""
    dev = resolve_device(device)
    H, W = cfg.in_res_hw
    states = []
    for stride, dim in zip(cfg.strides, cfg.stage_dims):
        shape = (batch_size, H // stride, W // stride, dim)
        states.append((torch.zeros(shape, dtype=dtype, device=dev),
                       torch.zeros(shape, dtype=dtype, device=dev)))
    return tuple(states)
