"""The streaming evaluation step.

Port of the serving half of ``rvt_tpu/training/step.py``: reset the LSTM
states of restarted lanes, scan the backbone over the window on the
hand-written kernels, gather the labelled frames, run PAFPN + YOLOX head,
sigmoid, and the on-device confidence filter + NMS. Mirrors the upstream
``_val_test_step_impl`` (modules/detection.py:208-280) in stream mode.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from rvt_tpu_torch.config import ExperimentConfig
from rvt_tpu_torch.models.backbone import LstmStates
from rvt_tpu_torch.models.detector import (RVTDetector,
                                           backbone_kernel_params,
                                           fused_scan_backbone)
from rvt_tpu_torch.ops.boxes import postprocess
from rvt_tpu_torch.ops.s2d import s2d_input_hw


class EvalOutput(NamedTuple):
    """The JAX step's five results, then the head output before sigmoid."""
    states: LstmStates
    dets: torch.Tensor        # [B, K, max_detections, 7]
    det_valid: torch.Tensor   # [B, K, max_detections] bool
    frame_idx: torch.Tensor   # [B, K]
    gval: torch.Tensor        # [B, K] bool
    preds: torch.Tensor       # [B*K, A, 5+C] f32


def reset_states(states: LstmStates, is_first_sample: torch.Tensor
                 ) -> LstmStates:
    """Zero the (h, c) of lanes whose stream restarted."""
    def mask(x):
        m = is_first_sample.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, torch.zeros_like(x), x)
    return tuple((mask(h), mask(c)) for h, c in states)


def gather_labeled_frames(feats: Tuple[torch.Tensor, ...],
                          frame_valid: torch.Tensor, max_frames: int):
    """Up to K labelled frames per lane, fixed shapes. feats: tuple of
    [T, B, h, w, c]; frame_valid: [B, T] bool. Returns (tuple of
    [B*K, h, w, c], frame_idx [B, K], gathered_valid [B, K]). A stable
    sort keeps time order; invalid frames sort last."""
    B, T = frame_valid.shape
    K = max_frames
    order = torch.argsort(torch.where(frame_valid, 0, 1), dim=1,
                          stable=True)
    frame_idx = order[:, :K]
    gathered_valid = torch.gather(frame_valid, 1, frame_idx)
    lanes = torch.arange(B, device=frame_idx.device)[:, None]

    def gather_one(f):
        g = f.transpose(0, 1)[lanes, frame_idx]  # [B, K, h, w, c]
        return g.reshape((B * K,) + tuple(f.shape[2:]))

    return tuple(gather_one(f) for f in feats), frame_idx, gathered_valid


def pad_ev_repr(ev: torch.Tensor, target_hw: Tuple[int, int], dtype,
                stem_s2d: bool = False) -> torch.Tensor:
    """Zero-pad bottom/right to the model resolution and convert dtype
    (``dtype=None`` keeps the storage dtype). s2d-blocked input arrives
    padded from the host; only its shape is checked."""
    if stem_s2d:
        if tuple(ev.shape[-3:-1]) != s2d_input_hw(target_hw):
            raise ValueError(f"expected s2d-blocked input, got {ev.shape}")
        return ev if dtype is None else ev.to(dtype)
    H, W = ev.shape[-3], ev.shape[-2]
    ph, pw = target_hw[0] - H, target_hw[1] - W
    if ph < 0 or pw < 0:
        raise ValueError(f"input {ev.shape} exceeds {target_hw}")
    if ph or pw:
        ev = F.pad(ev, (0, 0, 0, pw, 0, ph))
    return ev if dtype is None else ev.to(dtype)


def make_eval_step(model: RVTDetector, cfg: ExperimentConfig, *,
                   plain: bool = False):
    """Streaming evaluation step over one window, on the model's device.

    ``eval_step(lstm_states, ev_repr [B, T, ...], frame_valid [B, T],
    is_first_sample [B])`` returns an ``EvalOutput``. The window stays in
    its storage dtype (uint8); the stem conv casts it. The backbone's
    kernel weights are prepared here, once: a later change to the model's
    parameters needs a new step.
    ``plain=True`` runs the kernels' plain PyTorch versions (the
    reference the chip check holds the kernels against)."""
    K = cfg.dataset.max_labeled_frames
    pp = cfg.model.postprocess
    num_classes = cfg.model.head.num_classes
    in_res = cfg.model.backbone.in_res_hw
    stem_s2d = cfg.model.backbone.stem_s2d
    params = backbone_kernel_params(model)

    @torch.inference_mode()
    def eval_step(lstm_states: LstmStates, ev_repr: torch.Tensor,
                  frame_valid: torch.Tensor,
                  is_first_sample: torch.Tensor) -> EvalOutput:
        lstm_states = reset_states(lstm_states, is_first_sample)
        ev_seq = pad_ev_repr(ev_repr, in_res, None, stem_s2d)
        ev_seq = ev_seq.transpose(0, 1)
        feats, final_states = fused_scan_backbone(
            model, ev_seq, lstm_states, params, plain=plain)
        gathered, frame_idx, gval = gather_labeled_frames(feats,
                                                          frame_valid, K)
        preds = model.forward_detect(gathered)
        infer = torch.cat([preds[..., :4], torch.sigmoid(preds[..., 4:])],
                          dim=-1)
        dets, det_valid = postprocess(
            infer, num_classes, pp.confidence_threshold, pp.nms_threshold,
            pp.pre_nms_topk, pp.max_detections)
        B, Kk = frame_idx.shape
        dets = dets.reshape(B, Kk, *dets.shape[1:])
        det_valid = det_valid.reshape(B, Kk, -1) & gval[..., None]
        return EvalOutput(final_states, dets, det_valid, frame_idx, gval,
                          preds)

    return eval_step
