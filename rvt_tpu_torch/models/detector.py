"""RVT detector: recurrent backbone + PAFPN + YOLOX head.

Port of ``rvt_tpu/models/detector.py``. ``fused_scan_backbone`` is the
serving scan over a whole [T, B, ...] window: per stage the downsample
conv runs batched over all T*B frames (cuDNN, as XLA ran it in the JAX
package), then ``ops/fused_scan.fused_stage_scan`` runs the attention
pair and the ConvLSTM on the hand-written kernels. Inter-stage features
travel as bf16. ``RVTDetector.forward`` is one time step (the JAX
module's ``__call__``): the same scan over a window of one frame, each
stage then being ``ops/fused_scan.fused_stage``. ``fused_train_scan_backbone``
is the differentiable scan of the train step: the same stage loop, each
stage ``ops/fused_train.split_stage_scan_train`` on weights cast inside
autograd (or, with ``per_step``, ``fused_stage_step_train`` once per time
step).

Every entry point runs only configs and stage geometries that the JAX
package runs on its kernels (``require_fused_path``); the others take its
XLA module path, which the port has not ported, and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.config import ModelConfig
from rvt_tpu_torch.models.backbone import LstmStates, RVTBackbone
from rvt_tpu_torch.models.yolox import YoloPAFPN, YoloXHead
from rvt_tpu_torch.ops.fused_attention import (attention_block_params,
                                               pair_fusion_ok)
from rvt_tpu_torch.ops.fused_scan import fused_stage_scan, lstm_weights_t
from rvt_tpu_torch.ops.fused_train import (StageCfg, fused_stage_step_train,
                                           split_stage_scan_train,
                                           train_block_params, train_stage_ok)
from rvt_tpu_torch.ops.s2d import BLOCK, fold_stem_kernel, s2d_input_hw


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.compute_dtype]


def fused_path_supported(cfg: ModelConfig) -> bool:
    """Whether the JAX package runs this config's blocks on its kernels:
    the structural gate of its whole-window scans (``rvt_tpu/models/
    detector.py:_fused_scan_supported``) and of its single step
    (``PartitionAttentionCl._fused_mode``). Every other config runs the
    XLA module path (erf-gelu, LayerScale not folded), which the port has
    not ported. The JAX package also leaves its kernels per stage, by
    geometry: ``stage_path_supported``."""
    bb = cfg.backbone
    a, lstm = bb.attention, bb.lstm
    return (bb.fused_kernels and cfg.compute_dtype == "bfloat16"
            and all(n == 1 for n in bb.num_blocks)
            and not a.mlp_gated and a.attention_bias and a.mlp_bias
            and a.ls_init_value > 0 and a.drop_path == 0.0
            and a.drop_mlp == 0.0 and a.mlp_activation == "gelu"
            and not lstm.dws_conv and lstm.drop_cell_update == 0.0)


def stage_geometries(cfg: ModelConfig) -> List[Tuple[int, int, int]]:
    """(H, W, C) of each backbone stage at the config's input size."""
    bb = cfg.backbone
    Hi, Wi = bb.in_res_hw
    return [(Hi // s, Wi // s, C) for s, C in zip(bb.strides,
                                                   bb.stage_dims)]


# Where the JAX package runs a stage on its kernels, by path: serving
# (window scan, single step, raw events) where ``pair_fusion_mode`` is
# not None; training over the whole window or per step where
# ``train_stage_mode(scan=...)`` is not None.
_STAGE_ENVELOPES = {
    "serve": pair_fusion_ok,
    "train": lambda H, W, C, part: train_stage_ok(H, W, C, part, scan=True),
    "train_per_step": lambda H, W, C, part: train_stage_ok(H, W, C, part,
                                                           scan=False),
}


def stage_path_supported(cfg: ModelConfig, path: str) -> List[bool]:
    """Per stage, whether the JAX package runs it on its kernels on
    ``path`` ("serve", "train" or "train_per_step")."""
    part = tuple(cfg.backbone.attention.partition_size)
    ok = _STAGE_ENVELOPES[path]
    return [ok(H, W, C, part) for H, W, C in stage_geometries(cfg)]


def require_fused_path(cfg: ModelConfig, path: str = "serve") -> None:
    """Raise ``NotImplementedError`` unless ``fused_path_supported`` and
    every stage is within the JAX package's envelope for ``path``."""
    if not fused_path_supported(cfg):
        raise NotImplementedError(
            "this config runs the JAX package's XLA module path (it needs "
            "fused_kernels=True, bf16 compute, one block per stage, the "
            "plain gelu MLP with biases, LayerScale > 0, no drop-path or "
            "drop-mlp and the 1x1 ConvLSTM without cell dropout); the port "
            "has not ported that path yet (ROADMAP)")
    for (H, W, C), ok in zip(stage_geometries(cfg),
                             stage_path_supported(cfg, path)):
        if not ok:
            raise NotImplementedError(
                f"the JAX package runs a {H}x{W}x{C} stage with partition "
                f"{tuple(cfg.backbone.attention.partition_size)} on its XLA "
                f"module path ({path}: its kernels' geometry envelope); the "
                "port has not ported that path yet (ROADMAP)")


class RVTDetector(nn.Module):
    """Parameters under upstream names: ``backbone``, ``fpn``,
    ``yolox_head``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = RVTBackbone(bb)
        in_ch = tuple(bb.stage_dims[s - 1] for s in cfg.fpn.in_stages)
        strides = tuple(bb.strides[s - 1] for s in cfg.fpn.in_stages)
        self.fpn = YoloPAFPN(cfg.fpn, in_ch)
        self.yolox_head = YoloXHead(cfg.head, in_ch, strides)

    def forward_backbone(self, x: torch.Tensor, prev_states: LstmStates,
                         params: List[Dict], *, plain: bool = False
                         ) -> Tuple[Dict[int, torch.Tensor], LstmStates]:
        """One time step of the backbone: x [B, H, W, C_in] (uint8 or
        float, padded to ``in_res_hw``), prev_states per stage. Each stage
        is the downsample conv, then ``ops/fused_scan.fused_stage`` (the
        downsample LN and the attention pair over the B frames, K1-K3;
        the ConvLSTM cell, K4 at T = 1): ``fused_scan_backbone`` over a
        window of one frame. ``params`` from ``backbone_kernel_params``.
        Returns ({stage: h_t f32}, new states)."""
        require_fused_path(self.cfg)
        _, states = fused_scan_backbone(self, x.unsqueeze(0), prev_states,
                                        params, plain=plain)
        return {i + 1: h for i, (h, _) in enumerate(states)}, states

    def forward(self, x: torch.Tensor, prev_states: LstmStates,
                params: List[Dict], *, plain: bool = False
                ) -> Tuple[torch.Tensor, LstmStates]:
        """Single-step full forward (the JAX module's ``__call__``):
        returns (preds [B, A, 5+C] f32, new states)."""
        feats, states = self.forward_backbone(x, prev_states, params,
                                              plain=plain)
        preds = self.forward_detect([feats[s]
                                     for s in self.cfg.fpn.in_stages])
        return preds, states

    def forward_detect(self, features) -> torch.Tensor:
        """features: NHWC stage maps at strides (8, 16, 32). Returns
        [B, A, 5+C] f32 (decoded cxcywh + obj/cls logits). In train mode
        BatchNorm runs on batch statistics and updates its buffers."""
        dtype = compute_dtype(self.cfg)
        nchw = [f.permute(0, 3, 1, 2) for f in features]  # channels_last
        return self.yolox_head(self.fpn(nchw, dtype), dtype)


def _init_weights(model: RVTDetector, gen: torch.Generator) -> None:
    """Random weights from ``gen`` with the JAX package's init scheme:
    lecun-normal (truncated) kernels, zero biases, unit norms, LayerScale
    at ``ls_init_value``, the head's prior-probability biases kept."""
    ls = model.cfg.backbone.attention.ls_init_value
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(ls)
            elif leaf == "mask_token":
                p.normal_(0.0, 0.02, generator=gen)
            elif p.dim() >= 2:
                std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
            elif leaf == "weight":
                p.fill_(1.0)
            elif not name.startswith(("yolox_head.cls_preds",
                                      "yolox_head.obj_preds")):
                p.zero_()


def init_detector(cfg: ModelConfig, seed: int = 0,
                  device="cuda") -> RVTDetector:
    """Build the detector with random weights made from ``seed``."""
    dev = resolve_device(device)
    model = RVTDetector(cfg)
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def model_input_hw_c(cfg: ModelConfig) -> Tuple[int, int, int]:
    """Spatial + channel shape of one input frame (depends on stem_s2d)."""
    H, W = cfg.backbone.in_res_hw
    C = cfg.backbone.input_channels
    if cfg.backbone.stem_s2d:
        hp, wp = s2d_input_hw((H, W))
        return hp, wp, BLOCK * BLOCK * C
    return H, W, C


def downsample_conv_apply(x: torch.Tensor, stage, cfg, is_stem: bool,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """The ConvDownsample conv alone on NHWC ``x`` (its LayerNorm runs in
    the stage kernels): operands in ``dtype``, no bias, NHWC out."""
    w = stage.downsample_cf2cl.conv.weight
    k = w.shape[-1]
    if is_stem and cfg.stem_s2d:
        w = fold_stem_kernel(w.permute(2, 3, 1, 0)).permute(3, 2, 0, 1)
        stride, pad = 1, 0
    else:
        stride = cfg.stem_patch_size if is_stem else 2
        pad = k // 2 if cfg.downsample.overlap else 0
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), w.to(dtype), None,
                 stride, pad)
    return y.permute(0, 2, 3, 1).contiguous()


def downsample_ln_params(stage, cfg, C: int, dtype=torch.bfloat16):
    """(scale, bias) of the downsample LayerNorm as [C] vectors (identity
    when the config has no affine norm)."""
    norm = stage.downsample_cf2cl.norm
    dev = stage.downsample_cf2cl.conv.weight.device
    if cfg.downsample.norm_affine:
        return norm.weight.to(dtype), norm.bias.to(dtype)
    return (torch.ones(C, dtype=dtype, device=dev),
            torch.zeros(C, dtype=dtype, device=dev))


def backbone_kernel_params(model: RVTDetector) -> List[Dict]:
    """Each stage's weights as its kernels take them (bf16, LayerScale
    folded, [in, out] layouts; the LSTM's also as K4's transposed halves,
    ``lstm_wt``). The serving step makes them once, when it is made,
    instead of once per window."""
    cfg = model.cfg.backbone
    bf16 = torch.bfloat16
    out = []
    with torch.no_grad():
        for stage, C in zip(model.backbone.stages, cfg.stage_dims):
            lstm = stage.lstm.conv1x1
            blk = stage.att_blocks[0]
            lstm_w = lstm.weight[:, :, 0, 0].t().to(bf16).contiguous()
            out.append(dict(
                params_window=attention_block_params(blk.att_window, True),
                params_grid=attention_block_params(blk.att_grid, False),
                lstm_w=lstm_w,
                lstm_wt=lstm_weights_t(lstm_w),
                lstm_b=lstm.bias.to(bf16),
                ds_ln_params=downsample_ln_params(stage, cfg, C)))
    return out


def fused_scan_backbone(model: RVTDetector, ev_seq: torch.Tensor,
                        init_states: LstmStates, params: List[Dict], *,
                        plain: bool = False
                        ) -> Tuple[Tuple[torch.Tensor, ...], LstmStates]:
    """Serving scan over a [T, B, H, W, C] window (uint8 or float input).

    Per stage: the downsample conv over all T*B frames, then
    ``fused_stage_scan`` (LN, attention pair and LSTM on the kernels) with
    the stage's ``params`` from ``backbone_kernel_params``. ``plain=True``
    runs the kernels' plain versions instead, on any device. Returns
    (features per ``cfg.fpn.in_stages``, each [T, B, h, w, c] bf16; final
    (h, c) f32 per stage)."""
    require_fused_path(model.cfg)
    cfg = model.cfg.backbone
    att = cfg.attention
    T, B = ev_seq.shape[:2]
    x = ev_seq.reshape((T * B,) + tuple(ev_seq.shape[2:]))
    feats: Dict[int, torch.Tensor] = {}
    states_out = []
    for idx, stage in enumerate(model.backbone.stages):
        x = downsample_conv_apply(x, stage, cfg, idx == 0, torch.bfloat16)
        h_dim, w_dim, C = x.shape[1:]
        h0, c0 = init_states[idx]
        h_seq, hT, cT = fused_stage_scan(
            x.view(T, B, h_dim, w_dim, C), h0=h0, c0=c0,
            heads=C // att.dim_head, dim_head=att.dim_head,
            part=tuple(att.partition_size), eps=att.norm_eps,
            ds_eps=cfg.downsample.norm_eps, plain=plain, **params[idx])
        states_out.append((hT, cT))
        feats[idx + 1] = h_seq
        x = h_seq.view(T * B, h_dim, w_dim, C)
    in_stages = model.cfg.fpn.in_stages
    return tuple(feats[s] for s in in_stages), tuple(states_out)


def _masked_ds_ln(x_seq: torch.Tensor, ds_s: torch.Tensor,
                  ds_b: torch.Tensor, eps: float, mask_token: torch.Tensor,
                  token_mask_seq: torch.Tensor) -> torch.Tensor:
    """Stage 1's downsample LayerNorm and the mask-token replacement in
    torch, differentiable in the LN affine and the mask token
    (``rvt_tpu/models/detector.py:437-457``; the reference applies the
    token to the normed downsample output, maxvit_rnn.py:174-176): f32
    statistics, the fast variance clamped at 0, rsqrt, the bf16 affine in
    f32, a bf16 result; then ``where(mask, bf16 token, x)``."""
    xf = x_seq.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * ds_s.float()
          + ds_b.float()).to(torch.bfloat16)
    mt = mask_token.to(torch.bfloat16).reshape(-1)
    return torch.where(token_mask_seq[..., None], mt, xn)


def fused_train_scan_backbone(model: RVTDetector, ev_seq: torch.Tensor,
                              init_states: LstmStates, *,
                              per_step: bool = False,
                              token_mask_seq: torch.Tensor | None = None,
                              plain: bool = False
                              ) -> Tuple[Tuple[torch.Tensor, ...],
                                         LstmStates]:
    """Differentiable backbone scan over a [T, B, H, W, C] window
    (``rvt_tpu/models/detector.py:fused_train_scan_backbone``). Per stage:
    the downsample conv over all T*B frames (cuDNN, with gradients), then
    ``split_stage_scan_train`` (the attention pair over the T*B frames and
    the LSTM scan, forward and backward on the kernels), or with
    ``per_step`` a loop over t of ``fused_stage_step_train`` on the B
    frames of each step. The stage's weights are cast to the kernels'
    layout inside autograd once per stage, as ``train_block_params`` does
    on every step; per step the carry stays f32 and each step's feature is
    ``h_t`` in bf16.

    ``token_mask_seq`` [T, B, h, w] bool at the stage-1 token grid (with
    ``enable_masking``): stage 1's downsample LN and the mask-token
    replacement run in torch (``_masked_ds_ln``) and its kernels skip
    their LN (``ds_ln=False``).

    The JAX package trains a stage on its kernels only within
    ``train_stage_mode`` (per step: every gen1 stage, not gen4's first);
    beyond it, it runs the XLA modules, and this raises. Returns
    (features per
    ``cfg.fpn.in_stages``, each [T, B, h, w, c] bf16; final (h, c) f32 per
    stage)."""
    require_fused_path(model.cfg, "train_per_step" if per_step else "train")
    cfg = model.cfg.backbone
    att = cfg.attention
    part = tuple(att.partition_size)
    T, B = ev_seq.shape[:2]
    bf16 = torch.bfloat16
    x = ev_seq.reshape((T * B,) + tuple(ev_seq.shape[2:]))
    feats: Dict[int, torch.Tensor] = {}
    states_out = []
    for idx, stage in enumerate(model.backbone.stages):
        x = downsample_conv_apply(x, stage, cfg, idx == 0, bf16)
        h_dim, w_dim, C = x.shape[1:]
        x_seq = x.view(T, B, h_dim, w_dim, C)
        ds_s, ds_b = downsample_ln_params(stage, cfg, C)
        masked = (token_mask_seq is not None and idx == 0
                  and cfg.enable_masking)
        if masked:
            x_seq = _masked_ds_ln(x_seq, ds_s, ds_b, cfg.downsample.norm_eps,
                                  stage.mask_token, token_mask_seq)
        lstm = stage.lstm.conv1x1
        blk = stage.att_blocks[0]
        scfg = StageCfg(C // att.dim_head, att.dim_head, part, att.norm_eps,
                        cfg.downsample.norm_eps, plain, not masked)
        args = (ds_s, ds_b, train_block_params(blk.att_window, True),
                train_block_params(blk.att_grid, False),
                lstm.weight[:, :, 0, 0].to(bf16).t().contiguous(),
                lstm.bias.to(bf16))
        h0, c0 = init_states[idx]
        if per_step:
            hT, cT = h0, c0
            hs = []
            # K4's layout of the LSTM weight, once for the window's steps
            wt = lstm_weights_t(args[4].detach())
            for t in range(T):
                hT, cT = fused_stage_step_train(scfg, x_seq[t], *args, hT,
                                                cT, lstm_wt=wt)
                hs.append(hT.to(bf16))
            h_seq = torch.stack(hs)
        else:
            h_seq, hT, cT = split_stage_scan_train(scfg, x_seq, *args, h0,
                                                   c0)
        states_out.append((hT, cT))
        feats[idx + 1] = h_seq
        x = h_seq.view(T * B, h_dim, w_dim, C)
    in_stages = model.cfg.fpn.in_stages
    return tuple(feats[s] for s in in_stages), tuple(states_out)
