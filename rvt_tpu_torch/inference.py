"""On-device inference from raw event streams to detections.

Port of ``rvt_tpu/inference.py``. One call per frame batch, everything on
the model's device:

  raw events (padded [B, N] x/y/p/t int32 + counts [B])
    -> stacked histogram (``ops/voxelization.py``, CUDA kernel
       ``stacked_histogram``), straight into the half-resolution grid
       for ds2 configs (gen4) unless ``ds2_direct=False``
    -> optional 2x nearest downsample
    -> pad to the model resolution (uint8; the stem conv casts to bf16)
    -> single-step recurrent detector (``RVTDetector.forward``: on the
       kernels, or on the modules where the JAX package runs its modules)
    -> sigmoid, confidence filter and NMS (``ops/boxes.py``)

Only the raw event arrays go to the device and the padded detections
come back.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rvt_tpu_torch.config import ExperimentConfig
from rvt_tpu_torch.models.backbone import LstmStates
from rvt_tpu_torch.models.detector import (RVTDetector,
                                           backbone_kernel_params,
                                           fused_path_supported)
from rvt_tpu_torch.ops.boxes import postprocess
from rvt_tpu_torch.ops.voxelization import stacked_histogram_batched
from rvt_tpu_torch.training.graphs import CapturedStep
from rvt_tpu_torch.training.step import reset_states
from rvt_tpu_torch.utils import timers

BINS = 10  # stacked_histogram_dt=50_nbins=10 (dataset presets)


def nearest_downsample2(x: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] 2x nearest-exact downsample (preprocess parity:
    src = floor((dst + 0.5) * 2) = 2*dst + 1)."""
    return x[..., 1::2, 1::2]


def ds2_retarget(x: torch.Tensor, y: torch.Tensor, bins: int, vH: int,
                 vW: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move odd-coordinate events into the half-resolution grid and every
    other event out of range, so that voxelizing into [vH, vW] equals
    voxelizing at full resolution and then ``nearest_downsample2``. The
    JAX package's Python floor-mod and floor-division, also for x < 0."""
    odd = (torch.remainder(x, 2) == 1) & (torch.remainder(y, 2) == 1)
    x2 = torch.where(odd, torch.div(x, 2, rounding_mode="floor"),
                     2 * bins * vH * vW)
    y2 = torch.where(odd, torch.div(y, 2, rounding_mode="floor"), vH)
    return x2.to(torch.int32), y2.to(torch.int32)


def event_frames(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                 t: torch.Tensor, counts: torch.Tensor, cfg: ExperimentConfig,
                 *, ds2_direct: bool = True,
                 plain: bool = False) -> torch.Tensor:
    """The detector's input for one call: the events' stacked histogram
    (at half resolution for ds2 configs), zero-padded to ``in_res_hw``,
    as an NHWC view [B, H, W, 2*bins] of uint8 counts."""
    sH, sW = cfg.dataset.resolution_hw
    ds2 = cfg.dataset.downsample_by_factor_2
    if ds2 and ds2_direct:
        vH, vW = sH // 2, sW // 2
        x, y = ds2_retarget(x, y, BINS, vH, vW)
    else:
        vH, vW = sH, sW
    frames = stacked_histogram_batched(x, y, p, t, counts, BINS, vH, vW,
                                       plain=plain)  # [B, 2*bins, H, W]
    if ds2 and not ds2_direct:
        frames = nearest_downsample2(frames)
    H, W = frames.shape[-2:]
    in_res = cfg.model.backbone.in_res_hw
    return F.pad(frames, (0, in_res[1] - W, 0, in_res[0] - H)
                 ).permute(0, 2, 3, 1)


def make_raw_inference_step(model: RVTDetector, cfg: ExperimentConfig, *,
                            ds2_direct: bool = True, plain: bool = False):
    """Build ``step(states, x, y, p, t, counts, is_first_sample) ->
    (states, dets [B, max_detections, 7], det_valid [B, max_detections])``
    on the model's device.

    x, y, p, t: [B, N] int32 (t sorted per lane, zero padded); counts: [B]
    int32 valid events per lane; one event frame per lane per call, the
    recurrent states carried. For a config on the kernels their weights
    are prepared here, once: a later change to the model's parameters
    needs a new step. On a card the step is a ``CapturedStep``: the
    voxelizer (its plan depends on the shapes alone), the detector and
    NMS, one CUDA graph.

    ``ds2_direct`` (configs with ``downsample_by_factor_2``, gen4):
    voxelize the odd-coordinate events straight into the half-resolution
    grid (``ds2_retarget``), bit-identical to voxelizing the full sensor
    and downsampling (``False``). ``plain=True`` runs every kernel's plain
    PyTorch version (the reference the chip check holds the kernels
    against), eagerly."""
    if cfg.model.backbone.stem_s2d:
        raise ValueError("the raw pipeline emits HWC frames; use "
                         "stem_s2d=False")
    pp = cfg.model.postprocess
    num_classes = cfg.model.head.num_classes
    params = (backbone_kernel_params(model)
              if fused_path_supported(model.cfg) else None)

    @torch.inference_mode()
    def step(states: LstmStates, x: torch.Tensor, y: torch.Tensor,
             p: torch.Tensor, t: torch.Tensor, counts: torch.Tensor,
             is_first_sample: torch.Tensor):
        timers.mark("input")
        model.eval()  # BatchNorm on its running statistics
        states = reset_states(states, is_first_sample)
        frames = event_frames(x, y, p, t, counts, cfg,
                              ds2_direct=ds2_direct, plain=plain)
        timers.mark("backbone")
        # marks "detect" between the backbone and the neck
        preds, new_states = model(frames, states, params, plain=plain)
        timers.mark("postprocess")
        infer = torch.cat([preds[..., :4], torch.sigmoid(preds[..., 4:])],
                          dim=-1)
        dets, valid = postprocess(infer, num_classes,
                                  pp.confidence_threshold, pp.nms_threshold,
                                  pp.pre_nms_topk, pp.max_detections,
                                  plain=plain)
        return new_states, dets, valid

    return step if plain else CapturedStep(step)
