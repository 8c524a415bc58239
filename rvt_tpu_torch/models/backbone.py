"""Recurrent MaxViT backbone ("MaxViTRNN"): parameters, states, one step.

Port of ``rvt_tpu/models/backbone.py``: 4 stages, each a strided-conv
downsample, attention pairs and a ConvLSTM; the stage's hidden state is
both its output and the FPN's skip feature. ``RVTBackbone.forward`` is
one time step on the modules (the JAX package's XLA module path); the
serving and training computations over a whole window on the kernels are
``models/detector.py:fused_scan_backbone`` and
``fused_train_scan_backbone``, and ``models/detector.py:scan_backbone``
routes between them as the JAX package's does.

Parameter names follow upstream ``maxvit_rnn.py``
(``stages.{i}.downsample_cf2cl``, ``stages.{i}.att_blocks.{j}``,
``stages.{i}.lstm``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.config import BackboneConfig
from rvt_tpu_torch.models.layers import (ConvDownsample, DWSConvLSTM2d,
                                         Gen, MaxVitAttentionPair)

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
        self.s2d = cfg.stem_s2d and downsample_factor == cfg.stem_patch_size

    def forward(self, x: torch.Tensor, h_c: LstmState,
                token_mask: Optional[torch.Tensor] = None, *,
                dtype: torch.dtype, deterministic: bool = True,
                gen: Gen = None, kernels: bool = False, plain: bool = False
                ) -> Tuple[torch.Tensor, LstmState]:
        """One step (``rvt_tpu/models/backbone.py:RVTStage.__call__``):
        downsample, the mask token where ``token_mask`` [B, h, w] is set
        (with ``enable_masking``), the attention pairs, the cell. Returns
        (h_t, (h_t, c_t)), f32. ``kernels``: the blocks may run on the
        kernels, as the JAX modules do when serving a ``fused_kernels``
        config in bf16."""
        x = self.downsample_cf2cl(x, dtype, self.s2d)
        if token_mask is not None and hasattr(self, "mask_token"):
            x = torch.where(token_mask[..., None],
                            self.mask_token.to(x.dtype).reshape(-1), x)
        for blk in self.att_blocks:
            x = blk(x, dtype, deterministic, gen, kernels=kernels,
                    plain=plain)
        h, c = self.lstm(x, h_c, dtype, deterministic, gen, kernels=kernels,
                         plain=plain)
        return h, (h, c)


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

    def forward(self, x: torch.Tensor, prev_states: LstmStates,
                token_mask: Optional[torch.Tensor] = None, *,
                dtype: torch.dtype, deterministic: bool = True,
                gen: Gen = None, kernels: bool = False, plain: bool = False
                ) -> Tuple[Dict[int, torch.Tensor], LstmStates]:
        """One time step on x [B, H, W, C_in] (uint8 or float, padded;
        s2d-blocked with ``stem_s2d``): ({1..4: h_t}, new states), as
        ``rvt_tpu/models/backbone.py:RVTBackbone.__call__``. The token mask
        reaches stage 1 only."""
        states, out = [], {}
        for i, stage in enumerate(self.stages):
            x, state = stage(x, prev_states[i],
                             token_mask if i == 0 else None, dtype=dtype,
                             deterministic=deterministic, gen=gen,
                             kernels=kernels, plain=plain)
            states.append(state)
            out[i + 1] = x
        return out, tuple(states)


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
