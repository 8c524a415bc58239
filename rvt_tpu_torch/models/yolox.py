"""YOLOX neck (PAFPN) and decoupled head.

Port of ``rvt_tpu/models/yolox.py`` (upstream Megvii ``network_blocks.py``,
``yolo_pafpn.py``, ``yolo_head.py``). Parameter names follow upstream.
The forward runs on NCHW-shaped tensors: the backbone's NHWC maps as
``channels_last`` views, so cuDNN reads the JAX package's layout as it
is; ``upsample2x`` and the concatenations leave NCHW memory, so every
conv after the first runs on NCHW.

Dtype flow, as in the JAX package: a BaseConv's conv runs in the compute
dtype (bf16 when serving), its BatchNorm (running statistics) and SiLU
in f32; the ``*_pred`` 1x1 convs run in f32 and the box decode is f32,
its log-sizes capped where exp would overflow (``LOG_WH_MAX``).
In train mode (``model.train()``, as the train step sets it) each
BatchNorm normalises with the batch statistics and updates its running
buffers as flax's ``nn.BatchNorm`` does (``rvt_tpu/models/yolox.py:60``,
momentum 0.9), BatchNorm and activation forward and backward in two
passes each way (``ops/bn_act.py``; hand-written kernels on a card).
Inside ``batch_norm_group(group)`` (the data-parallel train step) the
batch statistics are those of every rank's frames, as flax's are under
JAX's jit over a dp mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rvt_tpu_torch.config import FPNConfig, HeadConfig
from rvt_tpu_torch.ops.bn_act import activation, batch_norm_act_train

BN_EPS = 1e-5  # the JAX package's nn.BatchNorm epsilon
BN_MOMENTUM = 0.9  # and its momentum (flax: ra = m * ra + (1 - m) * batch)
# The largest log-size the decode exponentiates: exp(80) x stride 32 is
# 1.8e36 px, finite in f32. Above ~85 exp overflows to inf, and the loss's
# backward multiplies that inf by a zero gradient (the box's IoU does not
# move), a NaN that the clip spreads to every parameter. Only sizes beyond
# 5.5e34 strides change.
LOG_WH_MAX = 80.0
# (process group, plain) of train-mode BatchNorm: the ranks it averages its
# moments over, and whether it takes the plain version on a card
_BN_ROUTE = contextvars.ContextVar("rvt_bn_route", default=(None, False))


@contextlib.contextmanager
def batch_norm_group(group, *, plain: bool = False):
    """Within this block train-mode BatchNorm takes its moments over the
    ranks of ``group`` (None: this process's frames alone), and with
    ``plain`` its plain PyTorch version on a card too
    (``ops/bn_act.py``)."""
    token = _BN_ROUTE.set((group, plain))
    try:
        yield
    finally:
        _BN_ROUTE.reset(token)


class BaseConv(nn.Module):
    """Conv -> BatchNorm -> act (network_blocks.py:29-54)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int,
                 groups: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.act = act

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        c = self.conv
        y = F.conv2d(x.to(dtype), c.weight.to(dtype), None, c.stride,
                     c.padding, 1, c.groups)
        bn = self.bn
        if not bn.training:
            y = F.batch_norm(y.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps)
            return activation(self.act, y)
        group, plain = _BN_ROUTE.get()
        return batch_norm_act_train(y, bn, self.act, group, BN_MOMENTUM,
                                    plain=plain)


class DWConv(nn.Module):
    """Depthwise conv + pointwise conv (network_blocks.py:57-76)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 act: str = "silu"):
        super().__init__()
        self.dconv = BaseConv(cin, cin, ksize, stride, groups=cin, act=act)
        self.pconv = BaseConv(cin, cout, 1, 1, act=act)

    def forward(self, x, dtype):
        return self.pconv(self.dconv(x, dtype), dtype)


def _conv(cin, cout, ksize, stride, depthwise, act):
    if depthwise:
        return DWConv(cin, cout, ksize, stride, act=act)
    return BaseConv(cin, cout, ksize, stride, act=act)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 -> optional residual (network_blocks.py:79-101)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False,
                 act: str = "silu"):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = _conv(hidden, cout, 3, 1, depthwise, act)
        self.use_add = shortcut and cin == cout

    def forward(self, x, dtype):
        y = self.conv2(self.conv1(x, dtype), dtype)
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """CSP bottleneck stack (network_blocks.py:104-142)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False, act: str = "silu"):
        super().__init__()
        hidden = int(cout * expansion)
        self.conv1 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv2 = BaseConv(cin, hidden, 1, 1, act=act)
        self.conv3 = BaseConv(2 * hidden, cout, 1, 1, act=act)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise, act=act)
            for _ in range(n)])

    def forward(self, x, dtype):
        x1 = self.conv1(x, dtype)
        x2 = self.conv2(x, dtype)
        for block in self.m:
            x1 = block(x1, dtype)
        return self.conv3(torch.cat([x1, x2], dim=1), dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest 2x upsample of an NCHW-shaped tensor."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YoloPAFPN(nn.Module):
    """3-level top-down + bottom-up pyramid (yolo_pafpn.py:109-139)."""

    def __init__(self, cfg: FPNConfig, in_channels: Tuple[int, int, int]):
        super().__init__()
        dw, act = cfg.depthwise, cfg.act
        n = round(3 * cfg.depth)
        c2, c1, c0 = in_channels
        self.lateral_conv0 = BaseConv(c0, c1, 1, 1, act=act)
        self.C3_p4 = CSPLayer(2 * c1, c1, n, False, depthwise=dw, act=act)
        self.reduce_conv1 = BaseConv(c1, c2, 1, 1, act=act)
        self.C3_p3 = CSPLayer(2 * c2, c2, n, False, depthwise=dw, act=act)
        self.bu_conv2 = _conv(c2, c2, 3, 2, dw, act)
        self.C3_n3 = CSPLayer(2 * c2, c1, n, False, depthwise=dw, act=act)
        self.bu_conv1 = _conv(c1, c1, 3, 2, dw, act)
        self.C3_n4 = CSPLayer(2 * c1, c0, n, False, depthwise=dw, act=act)

    def forward(self, features: Sequence[torch.Tensor], dtype):
        x2, x1, x0 = features  # strides 8, 16, 32
        fpn_out0 = self.lateral_conv0(x0, dtype)
        f_out0 = self.C3_p4(torch.cat([upsample2x(fpn_out0), x1], 1), dtype)
        fpn_out1 = self.reduce_conv1(f_out0, dtype)
        pan_out2 = self.C3_p3(torch.cat([upsample2x(fpn_out1), x2], 1),
                              dtype)
        p_out1 = self.bu_conv2(pan_out2, dtype)
        pan_out1 = self.C3_n3(torch.cat([p_out1, fpn_out1], 1), dtype)
        p_out0 = self.bu_conv1(pan_out1, dtype)
        pan_out0 = self.C3_n4(torch.cat([p_out0, fpn_out0], 1), dtype)
        return pan_out2, pan_out1, pan_out0


def make_grids_and_strides(hw_per_level: Sequence[Tuple[int, int]],
                           strides: Sequence[int]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor-center grid (x, y) and per-anchor stride, concatenated over
    levels (yolo_head.py:268-283)."""
    grids, stride_list = [], []
    for (h, w), s in zip(hw_per_level, strides):
        yv, xv = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        grid = np.stack([xv, yv], axis=-1).reshape(-1, 2).astype(np.float32)
        grids.append(grid)
        stride_list.append(np.full((grid.shape[0], 1), s, dtype=np.float32))
    return np.concatenate(grids, axis=0), np.concatenate(stride_list, axis=0)


class YoloXHead(nn.Module):
    """Decoupled cls/reg/obj head + f32 decode (yolo_head.py:21-289).

    Returns [B, A, 4+1+C]: decoded boxes (cx, cy, w, h in input pixels)
    and raw objectness/class logits."""

    def __init__(self, cfg: HeadConfig, in_channels: Tuple[int, int, int],
                 strides: Tuple[int, int, int] = (8, 16, 32)):
        super().__init__()
        self.num_classes = cfg.num_classes
        self.strides = tuple(strides)
        self._grids = {}  # (feature sizes, device) -> (grid, strides)
        hidden = int(256 * in_channels[-1] / 1024)
        act, dw = cfg.act, cfg.depthwise
        prior = float(-np.log((1 - 0.01) / 0.01))
        self.stems = nn.ModuleList(BaseConv(c, hidden, 1, 1, act=act)
                                   for c in in_channels)

        def pair():
            return nn.Sequential(_conv(hidden, hidden, 3, 1, dw, act),
                                 _conv(hidden, hidden, 3, 1, dw, act))

        self.cls_convs = nn.ModuleList(pair() for _ in in_channels)
        self.reg_convs = nn.ModuleList(pair() for _ in in_channels)
        self.cls_preds = nn.ModuleList(nn.Conv2d(hidden, self.num_classes, 1)
                                       for _ in in_channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(hidden, 4, 1)
                                       for _ in in_channels)
        self.obj_preds = nn.ModuleList(nn.Conv2d(hidden, 1, 1)
                                       for _ in in_channels)
        with torch.no_grad():
            for p in list(self.cls_preds) + list(self.obj_preds):
                p.bias.fill_(prior)

    def _grid(self, hw, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The anchors' grid and strides on ``device``, made once a feature
        size (a step captured as a CUDA graph copies nothing from the
        host), outside inference mode, so that training may use them."""
        key = (tuple(hw), device)
        if key not in self._grids:
            grid, stride = make_grids_and_strides(hw, self.strides)
            with torch.inference_mode(False):
                self._grids[key] = (torch.from_numpy(grid).to(device),
                                    torch.from_numpy(stride).to(device))
        return self._grids[key]

    def forward(self, features: Sequence[torch.Tensor], dtype):
        outputs, hw = [], []
        for k, x in enumerate(features):
            x = self.stems[k](x, dtype)
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs[k]:
                cls_feat = conv(cls_feat, dtype)
            for conv in self.reg_convs[k]:
                reg_feat = conv(reg_feat, dtype)
            # prediction convs in f32 (their inputs are the f32 SiLU outputs)
            cls_out = self.cls_preds[k](cls_feat.float())
            reg_out = self.reg_preds[k](reg_feat.float())
            obj_out = self.obj_preds[k](reg_feat.float())
            B, _, H, W = reg_out.shape
            hw.append((H, W))
            out = torch.cat([reg_out, obj_out, cls_out], dim=1)
            outputs.append(out.permute(0, 2, 3, 1).reshape(B, H * W, -1))
        out = torch.cat(outputs, dim=1)
        grid, stride = self._grid(hw, out.device)
        reg = out[..., :4].float()
        xy = (reg[..., :2] + grid) * stride
        wh = torch.exp(reg[..., 2:4].clamp(max=LOG_WH_MAX)) * stride
        return torch.cat([xy, wh, out[..., 4:].float()], dim=-1)
