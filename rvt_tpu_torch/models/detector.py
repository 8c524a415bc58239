"""RVT detector: recurrent backbone + PAFPN + YOLOX head.

Port of ``rvt_tpu/models/detector.py``. ``scan_backbone`` runs the
backbone over a [T, B, ...] window and routes as the JAX package's does
(``stage_routes`` names the route of each stage):

- ``fused_scan_backbone`` serves configs that the JAX package runs on its
  kernels (``fused_path_supported``): per stage the downsample conv runs
  batched over all T*B frames (cuDNN, as XLA ran it), then
  ``ops/fused_scan.fused_stage_scan`` runs the attention pair and the
  ConvLSTM on the hand-written kernels; a stage outside the kernels'
  geometry envelope runs the module pair and then the cell on K4 at
  T = 1, a step at a time. Inter-stage features travel as bf16.
- ``fused_train_scan_backbone`` is the differentiable scan of the train
  step for those configs: the same stage loop, each stage
  ``ops/fused_train.split_stage_scan_train`` on weights cast inside
  autograd (or, with ``per_step``, ``fused_stage_step_train`` once per
  time step); a stage outside the training envelope runs the module pair
  and cell in bf16 a step at a time under ``torch.utils.checkpoint``.
- every other config and call (the shipped presets among them: f32,
  ``fused_kernels`` off) runs the modules of ``models/layers.py`` a step
  at a time (``RVTDetector.forward_backbone``), each step under
  ``torch.utils.checkpoint`` when training, as ``jax.checkpoint`` does
  (without saving the RNG state: a train step draws no random numbers,
  and saving it would break the step's CUDA graph capture).

``RVTDetector.forward`` is one time step (the JAX module's ``__call__``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.config import ModelConfig
from rvt_tpu_torch.models.backbone import LstmStates, RVTBackbone
from rvt_tpu_torch.models.layers import (attention_variant_shipped,
                                         lstm_variant_shipped)
from rvt_tpu_torch.models.yolox import YoloPAFPN, YoloXHead
from rvt_tpu_torch.ops.fused_attention import (attention_block_params,
                                               pair_fusion_ok)
from rvt_tpu_torch.ops.fused_scan import (fused_conv_lstm, fused_stage_scan,
                                          lstm_weights_t)
from rvt_tpu_torch.ops.fused_train import (StageCfg, fused_stage_step_train,
                                           split_stage_scan_train,
                                           train_block_params, train_stage_ok)
from rvt_tpu_torch.ops.s2d import BLOCK, s2d_input_hw
from rvt_tpu_torch.utils import timers


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[cfg.compute_dtype]


def fused_path_supported(cfg: ModelConfig) -> bool:
    """Whether the JAX package runs this config's window scans on its
    kernels: the structural gate of ``rvt_tpu/models/detector.py:
    _fused_scan_supported`` (``fused_kernels``, bf16, one block per stage,
    the shipped block and cell variants). Every other config runs the
    module path. The JAX package also leaves its kernels per stage, by
    geometry: ``stage_path_supported``."""
    bb = cfg.backbone
    return (bb.fused_kernels and cfg.compute_dtype == "bfloat16"
            and all(n == 1 for n in bb.num_blocks)
            and attention_variant_shipped(bb.attention)
            and lstm_variant_shipped(bb.lstm))


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


def stage_routes(cfg: ModelConfig, path: str = "serve") -> List[str]:
    """Per stage, what the port runs on ``path`` ("serve": the eval window,
    the single step and the raw step; "train": the train step's window;
    "train_per_step"), as the JAX package routes it:

    - "kernels": the whole stage on the hand-written kernels;
    - "modules+K4": the module attention pair in bf16, then the cell on
      K4 at T = 1, a step at a time (a ``fused_path_supported`` config
      served outside the kernels' envelope,
      ``rvt_tpu/models/detector.py:345-370``);
    - "modules": the module path (every stage of a config that
      ``fused_path_supported`` refuses, the shipped presets among them;
      a training stage outside the envelope, in bf16 under checkpoint,
      ``:487-520``)."""
    if not fused_path_supported(cfg):
        return ["modules"] * len(cfg.backbone.stage_dims)
    off = "modules+K4" if path == "serve" else "modules"
    return ["kernels" if ok else off for ok in stage_path_supported(cfg,
                                                                    path)]


def kernels_serve(cfg: ModelConfig, deterministic: bool) -> bool:
    """Whether the modules may run their blocks on the kernels: serving
    (``deterministic``) a ``fused_kernels`` config in bf16, as the JAX
    modules' ``_fused_mode`` / ``_fused_supported`` require."""
    return (deterministic and cfg.backbone.fused_kernels
            and cfg.compute_dtype == "bfloat16")


def dropout_rates(cfg: ModelConfig) -> Dict[str, float]:
    """The config's dropout rates above 0, by field."""
    a, lstm = cfg.backbone.attention, cfg.backbone.lstm
    rates = {"drop_path": a.drop_path, "drop_mlp": a.drop_mlp,
             "drop_cell_update": lstm.drop_cell_update}
    return {k: v for k, v in rates.items() if v > 0}


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
                         params: List[Dict] | None = None, *,
                         token_mask: torch.Tensor | None = None,
                         deterministic: bool = True,
                         gen: torch.Generator | None = None,
                         plain: bool = False
                         ) -> Tuple[Dict[int, torch.Tensor], LstmStates]:
        """One time step of the backbone: x [B, H, W, C_in] (uint8 or
        float, padded to ``in_res_hw``), prev_states per stage. Returns
        ({stage: h_t f32}, new states).

        Serving a ``fused_path_supported`` config without a token mask,
        this is ``fused_scan_backbone`` over a window of one frame (each
        stage the downsample conv, then ``ops/fused_scan.fused_stage``, or
        the module pair and K4 outside the envelope), with ``params`` from
        ``backbone_kernel_params`` (made here when None). Otherwise the
        modules run (``RVTBackbone.forward``), dropout from ``gen``;
        serving a ``fused_kernels`` config in bf16 they run their blocks on
        the kernels where the JAX modules do."""
        cfg = self.cfg
        if (fused_path_supported(cfg) and deterministic
                and token_mask is None):
            if params is None:
                params = backbone_kernel_params(self)
            _, states = fused_scan_backbone(self, x.unsqueeze(0),
                                            prev_states, params, plain=plain)
            return {i + 1: h for i, (h, _) in enumerate(states)}, states
        return self.backbone(x, prev_states, token_mask,
                             dtype=compute_dtype(cfg),
                             deterministic=deterministic, gen=gen,
                             kernels=kernels_serve(cfg, deterministic),
                             plain=plain)

    def forward(self, x: torch.Tensor, prev_states: LstmStates,
                params: List[Dict] | None = None, *,
                token_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                gen: torch.Generator | None = None, plain: bool = False
                ) -> Tuple[torch.Tensor, LstmStates]:
        """Single-step full forward (the JAX module's ``__call__``):
        returns (preds [B, A, 5+C] f32, new states). BatchNorm follows
        ``model.train()`` / ``model.eval()``."""
        feats, states = self.forward_backbone(
            x, prev_states, params, token_mask=token_mask,
            deterministic=deterministic, gen=gen, plain=plain)
        timers.mark("detect")  # a step's layer (utils/timers.py)
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
    return stage.downsample_cf2cl.conv_apply(x, dtype,
                                             is_stem and cfg.stem_s2d)


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
    the stage's ``params`` from ``backbone_kernel_params``. A stage outside
    the kernels' envelope (``stage_routes``: "modules+K4") takes the
    downsample LN in torch, then a step at a time the module pair in bf16
    and the cell on K4 at T = 1 (``rvt_tpu/models/detector.py:345-370``).
    ``plain=True`` runs the kernels' plain versions instead, on any
    device. A config that ``fused_path_supported`` refuses runs the
    module path (``scan_backbone``; ``params`` unused). Returns (features
    per ``cfg.fpn.in_stages``, each [T, B, h, w, c] bf16; final (h, c) f32
    per stage)."""
    if not fused_path_supported(model.cfg):
        return scan_backbone(model, ev_seq, init_states, plain=plain)
    cfg = model.cfg.backbone
    att = cfg.attention
    bf16 = torch.bfloat16
    T, B = ev_seq.shape[:2]
    x = ev_seq.reshape((T * B,) + tuple(ev_seq.shape[2:]))
    feats: Dict[int, torch.Tensor] = {}
    states_out = []
    for idx, (stage, route) in enumerate(zip(model.backbone.stages,
                                             stage_routes(model.cfg))):
        x = downsample_conv_apply(x, stage, cfg, idx == 0, bf16)
        h_dim, w_dim, C = x.shape[1:]
        x_seq = x.view(T, B, h_dim, w_dim, C)
        h0, c0 = init_states[idx]
        prm = params[idx]
        if route == "kernels":
            h_seq, hT, cT = fused_stage_scan(
                x_seq, h0=h0, c0=c0, heads=C // att.dim_head,
                dim_head=att.dim_head, part=tuple(att.partition_size),
                eps=att.norm_eps, ds_eps=cfg.downsample.norm_eps,
                plain=plain, **prm)
        else:
            x_seq = _ds_ln(x_seq, *prm["ds_ln_params"],
                           cfg.downsample.norm_eps)
            pair = stage.att_blocks[0]
            hT, cT = h0, c0
            hs = []
            for t in range(T):
                y = pair(x_seq[t], bf16, True)
                hT, cT = fused_conv_lstm(y, hT, cT, prm["lstm_w"],
                                         prm["lstm_b"], plain=plain)
                hs.append(hT.to(bf16))
            h_seq = torch.stack(hs)
        states_out.append((hT, cT))
        feats[idx + 1] = h_seq
        x = h_seq.view(T * B, h_dim, w_dim, C)
    in_stages = model.cfg.fpn.in_stages
    return tuple(feats[s] for s in in_stages), tuple(states_out)


def _ds_ln(x_seq: torch.Tensor, ds_s: torch.Tensor, ds_b: torch.Tensor,
           eps: float) -> torch.Tensor:
    """The downsample LayerNorm in torch, as the JAX package writes it
    beside its kernels (``rvt_tpu/models/detector.py:437-457``):
    differentiable in the bf16 affine, f32 statistics, the fast variance
    clamped at 0, rsqrt, the affine in f32, a bf16 result."""
    xf = x_seq.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return ((xf - mu) * torch.rsqrt(var + eps) * ds_s.float()
            + ds_b.float()).to(torch.bfloat16)


def _masked_ds_ln(x_seq: torch.Tensor, ds_s: torch.Tensor,
                  ds_b: torch.Tensor, eps: float, mask_token: torch.Tensor,
                  token_mask_seq: torch.Tensor) -> torch.Tensor:
    """Stage 1's downsample LayerNorm (``_ds_ln``) and the mask-token
    replacement, differentiable in the LN affine and the mask token (the
    reference applies the token to the normed downsample output,
    maxvit_rnn.py:174-176): ``where(mask, bf16 token, x)``."""
    xn = _ds_ln(x_seq, ds_s, ds_b, eps)
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
    beyond it (``stage_routes``: "modules") the stage runs the module pair
    and cell in bf16 on the normed input, a step at a time, each step
    under ``torch.utils.checkpoint``. A config that
    ``fused_path_supported`` refuses runs the module path
    (``scan_backbone``). Returns (features per ``cfg.fpn.in_stages``,
    each [T, B, h, w, c] bf16; final (h, c) f32 per stage)."""
    if not fused_path_supported(model.cfg):
        return scan_backbone(model, ev_seq, init_states, token_mask_seq,
                             deterministic=False, remat=True, plain=plain)
    routes = stage_routes(model.cfg,
                          "train_per_step" if per_step else "train")
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
        h0, c0 = init_states[idx]
        if routes[idx] == "modules":
            h_seq, hT, cT = _module_stage_train(stage, x_seq, ds_s, ds_b,
                                                cfg.downsample.norm_eps,
                                                not masked, h0, c0)
            states_out.append((hT, cT))
            feats[idx + 1] = h_seq
            x = h_seq.view(T * B, h_dim, w_dim, C)
            continue
        lstm = stage.lstm.conv1x1
        blk = stage.att_blocks[0]
        scfg = StageCfg(C // att.dim_head, att.dim_head, part, att.norm_eps,
                        cfg.downsample.norm_eps, plain, not masked)
        args = (ds_s, ds_b, train_block_params(blk.att_window, True),
                train_block_params(blk.att_grid, False),
                lstm.weight[:, :, 0, 0].to(bf16).t().contiguous(),
                lstm.bias.to(bf16))
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


def _module_stage_train(stage, x_seq, ds_s, ds_b, eps, ln: bool, h0, c0):
    """A training stage outside the kernels' envelope
    (``rvt_tpu/models/detector.py:487-520``): a step at a time, under
    ``torch.utils.checkpoint``, the downsample LN (``ln``; else x_seq is
    already normed and masked), the module pair and the module cell in
    bf16, not deterministic. Returns (h_seq bf16, h_T, c_T f32)."""
    bf16 = torch.bfloat16
    pair, cell = stage.att_blocks[0], stage.lstm

    def step(x_t, h, c):
        y = pair(_ds_ln(x_t, ds_s, ds_b, eps) if ln else x_t, bf16, False)
        return cell(y, (h, c), bf16, False)

    hT, cT = h0, c0
    hs = []
    for t in range(x_seq.shape[0]):
        hT, cT = checkpoint(step, x_seq[t], hT, cT, use_reentrant=False,
                            preserve_rng_state=False)
        hs.append(hT.to(bf16))
    return torch.stack(hs), hT, cT


def scan_backbone(model: RVTDetector, ev_seq: torch.Tensor,
                  init_states: LstmStates,
                  token_mask_seq: torch.Tensor | None = None, *,
                  deterministic: bool = True, remat: bool = False,
                  params: List[Dict] | None = None, plain: bool = False
                  ) -> Tuple[Tuple[torch.Tensor, ...], LstmStates]:
    """The backbone over a [T, B, H, W, C] window, routed as
    ``rvt_tpu/models/detector.py:scan_backbone`` routes: a
    ``fused_path_supported`` config serves (``deterministic``, no
    ``remat``, no token mask) on ``fused_scan_backbone`` (``params`` from
    ``backbone_kernel_params``, made here when None) and trains (not
    ``deterministic``) on ``fused_train_scan_backbone``. Every other call
    runs the modules a step at a time (``RVTDetector.forward_backbone``
    without a generator: a dropout rate above 0 raises when not
    ``deterministic``, as JAX's module does without a 'dropout' rng),
    each step under ``torch.utils.checkpoint`` with ``remat``.
    ``token_mask_seq`` [T, B, h, w] bool at the stage-1 token grid.
    Returns (features per ``cfg.fpn.in_stages``, each [T, B, h, w, c];
    final (h, c) f32 per stage)."""
    cfg = model.cfg
    fused_ok = fused_path_supported(cfg) and (token_mask_seq is None
                                              or not deterministic)
    if fused_ok and deterministic and not remat:
        if params is None:
            params = backbone_kernel_params(model)
        return fused_scan_backbone(model, ev_seq, init_states, params,
                                   plain=plain)
    if fused_ok and not deterministic:
        return fused_train_scan_backbone(model, ev_seq, init_states,
                                         token_mask_seq=token_mask_seq,
                                         plain=plain)
    in_stages = cfg.fpn.in_stages

    def step(x, states, tm):
        feats, new_states = model.forward_backbone(
            x, states, token_mask=tm, deterministic=deterministic,
            plain=plain)
        return tuple(feats[s] for s in in_stages), new_states

    states = init_states
    outs = []
    for t in range(ev_seq.shape[0]):
        tm = None if token_mask_seq is None else token_mask_seq[t]
        if remat:
            f, states = checkpoint(step, ev_seq[t], states, tm,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            f, states = step(ev_seq[t], states, tm)
        outs.append(f)
    return (tuple(torch.stack([o[i] for o in outs])
                  for i in range(len(in_stages))), states)
