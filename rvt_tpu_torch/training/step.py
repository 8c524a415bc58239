"""The TBPTT train step and the streaming evaluation step.

Port of ``rvt_tpu/training/step.py``. The train step (upstream
``modules/detection.py:104-158``): reset the LSTM states of restarted
lanes, scan the backbone over the window with gradients
(``models/detector.py:scan_backbone``: on the hand-written forward and
backward kernels where the JAX package runs its own, else on the modules
under checkpoint), gather the labelled frames and
their labels, run PAFPN + YOLOX head with batch-statistics BatchNorm, the
SimOTA YOLOX loss, backpropagate, clip and AdamW; optionally with a
stage-1 token mask, the training batch's detections (``with_detections``)
and per-parameter gradient and weight magnitudes (``with_param_metrics``).
The eval step: the same scan without gradients, then sigmoid and the
on-device confidence filter + NMS (``_val_test_step_impl``,
modules/detection.py:208-280, stream mode).

On a card both steps are captured CUDA graphs (``training/graphs.py``,
the port's ``jax.jit``), captured on their first call per signature; the
step bodies read nothing back from the device. Each body marks its layers
for tracing (``utils/timers.py:mark``): the eval step ``input``,
``backbone``, ``detect`` (the gather of labelled frames, PAFPN, head),
``postprocess``; the train step ``input``, ``backbone``, ``detect``,
``loss``, ``detect_bwd``, ``backbone_bwd`` (from when the gradient has
reached the gathered features), with a data-parallel group ``allreduce``
(the flat gradient all-reduce and the loss parts' sum), ``optimizer``.
The train step also runs data-parallel (``group``, ``parallel/mesh.py``)
on each rank's lanes of the global batch, computing JAX's global-batch
step; the eval step runs per rank on its own lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from rvt_tpu_torch.config import BackboneConfig, ExperimentConfig
from rvt_tpu_torch.models.backbone import LstmStates
from rvt_tpu_torch.models.detector import (RVTDetector,
                                           backbone_kernel_params,
                                           dropout_rates,
                                           fused_path_supported,
                                           init_detector, scan_backbone)
from rvt_tpu_torch.models.yolox import (batch_norm_group,
                                        make_grids_and_strides)
from rvt_tpu_torch.ops.boxes import postprocess
from rvt_tpu_torch.ops.s2d import s2d_input_hw, window_s2d
from rvt_tpu_torch.training.graphs import CapturedStep
from rvt_tpu_torch.training.losses import yolox_loss
from rvt_tpu_torch.training.optimizer import OneCycleAdamW, make_optimizer
from rvt_tpu_torch.utils import timers


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


def head_grid(cfg: ExperimentConfig) -> Tuple[np.ndarray, np.ndarray]:
    """The anchors' grid cells [A, 2] and strides [A] of the head."""
    H, W = cfg.model.backbone.in_res_hw
    strides = tuple(cfg.model.backbone.strides[s - 1]
                    for s in cfg.model.fpn.in_stages)
    grid, stride = make_grids_and_strides([(H // s, W // s) for s in strides],
                                          strides)
    return grid, stride[:, 0]


def gather_labels(labels: torch.Tensor, label_mask: torch.Tensor,
                  frame_idx: torch.Tensor):
    """labels [B, T, M, 7] storage rows (t, x, y, w, h, class, ...) of the
    gathered frames -> YOLOX targets [B*K, M, 5] (class, cx, cy, w, h) and
    their mask [B*K, M] (labels.py:341-355)."""
    B, T, M, _ = labels.shape
    K = frame_idx.shape[1]
    lanes = torch.arange(B, device=frame_idx.device)[:, None]
    lab = labels[lanes, frame_idx].reshape(B * K, M, 7)
    mask = label_mask[lanes, frame_idx].reshape(B * K, M)
    cx = lab[..., 1] + 0.5 * lab[..., 3]
    cy = lab[..., 2] + 0.5 * lab[..., 4]
    return torch.stack([lab[..., 5], cx, cy, lab[..., 3], lab[..., 4]],
                       dim=-1), mask


def pad_token_mask(tm: torch.Tensor, in_res_hw: Tuple[int, int],
                   patch_size: int) -> torch.Tensor:
    """Corner-pad a [..., h, w] stage-1 token mask from the storage
    resolution's token grid to the model resolution's; padding tokens are
    never masked (``rvt_tpu/training/step.py:pad_token_mask``)."""
    th, tw = in_res_hw[0] // patch_size, in_res_hw[1] // patch_size
    ph, pw = th - tm.shape[-2], tw - tm.shape[-1]
    if ph < 0 or pw < 0:
        raise ValueError(f"token mask {tuple(tm.shape)} exceeds {(th, tw)}")
    if ph or pw:
        tm = F.pad(tm, (0, pw, 0, ph))
    return tm


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


def window_seq(ev: torch.Tensor, bb: BackboneConfig, dtype,
               plain: bool = False) -> torch.Tensor:
    """A window [B, T, ...] as the backbone scan takes it: T-major, padded
    to the model resolution, in ``dtype`` (None: bf16 for an unblocked s2d
    window, else the storage dtype). The route follows the window's last
    axis: with ``bb.stem_s2d`` an unblocked window ([B, T, H, W, C],
    ``input_channels`` last; the feed's channel-last view of the stored
    buffer) is blocked and cast in one pass (``ops/s2d.py:window_s2d``), a
    blocked one (16*C last) goes through ``pad_ev_repr``."""
    if bb.stem_s2d and ev.shape[-1] == bb.input_channels:
        x = window_s2d(ev, bb.in_res_hw, plain=plain)
        return x if dtype is None else x.to(dtype)
    return pad_ev_repr(ev, bb.in_res_hw, dtype, bb.stem_s2d).transpose(0, 1)


def _postprocess_window(preds: torch.Tensor, frame_idx: torch.Tensor,
                        gval: torch.Tensor, cfg: ExperimentConfig,
                        plain: bool = False):
    """Sigmoid, confidence filter and NMS of the head's decoded predictions
    [B*K, A, 5+C] of a window; returns (dets [B, K, max_detections, 7],
    det_valid [B, K, max_detections], masked by the frames' validity)."""
    pp = cfg.model.postprocess
    infer = torch.cat([preds[..., :4], torch.sigmoid(preds[..., 4:])],
                      dim=-1)
    dets, det_valid = postprocess(
        infer, cfg.model.head.num_classes, pp.confidence_threshold,
        pp.nms_threshold, pp.pre_nms_topk, pp.max_detections, plain=plain)
    B, K = frame_idx.shape
    dets = dets.reshape(B, K, *dets.shape[1:])
    return dets, det_valid.reshape(B, K, -1) & gval[..., None]


def make_eval_step(model: RVTDetector, cfg: ExperimentConfig, *,
                   plain: bool = False):
    """Streaming evaluation step over one window, on the model's device.

    ``eval_step(lstm_states, ev_repr [B, T, ...], frame_valid [B, T],
    is_first_sample [B])`` returns an ``EvalOutput``. An unblocked window
    for an s2d stem becomes the stem's bf16 operand in the ``input``
    layer (``window_seq``); any other stays in its storage dtype (uint8)
    and the stem conv casts it. The backbone runs
    as ``scan_backbone`` routes it; for a config on the kernels their
    weights are prepared here, once: a later change to the model's
    parameters needs a new step. On a card the step is a
    ``CapturedStep``: the whole window, from the state reset through NMS,
    one CUDA graph.
    ``plain=True`` runs the kernels' plain PyTorch versions (the
    reference the chip check holds the kernels against), eagerly."""
    K = cfg.dataset.max_labeled_frames
    bb = cfg.model.backbone
    params = (backbone_kernel_params(model)
              if fused_path_supported(model.cfg) else None)

    @torch.inference_mode()
    def eval_step(lstm_states: LstmStates, ev_repr: torch.Tensor,
                  frame_valid: torch.Tensor,
                  is_first_sample: torch.Tensor) -> EvalOutput:
        timers.mark("input")
        model.eval()  # BatchNorm on its running statistics
        lstm_states = reset_states(lstm_states, is_first_sample)
        ev_seq = window_seq(ev_repr, bb, None, plain)
        timers.mark("backbone")
        feats, final_states = scan_backbone(
            model, ev_seq, lstm_states, params=params, plain=plain)
        timers.mark("detect")
        gathered, frame_idx, gval = gather_labeled_frames(feats,
                                                          frame_valid, K)
        preds = model.forward_detect(gathered)
        timers.mark("postprocess")
        dets, det_valid = _postprocess_window(preds, frame_idx, gval, cfg,
                                              plain)
        return EvalOutput(final_states, dets, det_valid, frame_idx, gval,
                          preds)

    return eval_step if plain else CapturedStep(eval_step)


# the train step's loss parts: each rank's sum over the global foreground
# count, summed over the ranks in data parallelism
LOSS_PARTS = ("loss", "iou_loss", "conf_loss", "cls_loss")


class TrainState(NamedTuple):
    """What the train step updates: the model (parameters and BatchNorm
    buffers) and the optimizer (moments and step count)."""
    model: RVTDetector
    optimizer: OneCycleAdamW


def init_train_state(cfg: ExperimentConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """Random weights from ``seed`` and a fresh optimizer, on ``device``."""
    model = init_detector(cfg.model, seed=seed, device=device)
    return TrainState(model, make_optimizer(model.parameters(),
                                            cfg.training))


def make_train_step(model: RVTDetector, cfg: ExperimentConfig,
                    optimizer: OneCycleAdamW, *, plain: bool = False,
                    with_detections: bool = False,
                    with_param_metrics: bool = False, graph_pool=None,
                    group=None):
    """One TBPTT window on the model's device.

    ``train_step(lstm_states, ev_repr [B, T, H, W, C], labels [B, T, M, 7],
    label_mask [B, T, M], frame_valid [B, T], is_first_sample [B],
    token_mask=None)`` updates the model's parameters and BatchNorm
    buffers and the optimizer in place and returns (the final LSTM
    states, detached: the TBPTT cut; metrics ``loss``, ``iou_loss``,
    ``conf_loss``, ``cls_loss``, ``num_fg`` and ``grad_norm``, the norm of
    the raw gradients, which stay in each parameter's ``.grad``).
    ``token_mask`` [B, T, h, w] bool at the storage resolution's stage-1
    token grid replaces the masked tokens by the learned mask token (with
    ``enable_masking``). With ``stem_s2d`` the window comes unblocked or
    blocked (``window_seq``); the step's scan takes it in f32.

    ``with_param_metrics`` adds ``gradflow/<name>``, the mean |grad| of
    each parameter (zero where it has none), and ``weights/<name>``, its
    mean |w| after the update, under the port's parameter names.
    ``with_detections`` also returns (dets, det_valid, frame_idx, gval):
    the eval step's postprocess of this forward's decoded predictions,
    computed without gradients. ``plain=True`` runs the kernels' plain
    PyTorch versions, eagerly.

    On a card the step is a ``CapturedStep``: zero-grad, forward, loss,
    backward, clip, AdamW and the BatchNorm updates, one CUDA graph; the
    optimizer's scalars reach the device before each replay. The
    gradients keep their tensors across steps (``zero_grad`` zeroes them
    in place). ``graph_pool`` is a memory pool
    (``torch.cuda.graph_pool_handle()``) its graphs share with other
    steps' that never run at the same time, the Trainer's variants.

    ``group``: the data-parallel process group (``parallel/mesh.py``).
    Each rank passes its lanes of the global batch and its LSTM states;
    the step computes the JAX package's step over the global batch (its
    dp mesh under jit): the foreground and GT counts summed over the
    ranks before the loss divides by them, BatchNorm's moments averaged
    over the ranks (one autograd-aware all-reduce a layer), the
    gradients summed (one flat all-reduce) before the clip and
    ``grad_norm``; the loss parts returned are the sums over the ranks,
    the same on every rank, and so is the update. With one rank every
    collective is the identity and the step is the plain one bit for
    bit. Over NCCL the collectives are captured in the step's graph;
    over gloo, which a capture cannot take, the step runs eagerly.

    A config with a dropout rate above 0 raises here: the JAX package's
    train step passes its modules no 'dropout' rng, and flax raises."""
    rates = dropout_rates(model.cfg)
    if rates:
        raise NotImplementedError(
            f"dropout in training ({rates}): the JAX package's train step "
            "passes no 'dropout' rng to its backbone scan, so its modules "
            "raise (flax InvalidRngError); the port's train step does the "
            "same")
    grid_np, stride_np = head_grid(cfg)
    dev = next(model.parameters()).device
    grid = torch.from_numpy(grid_np).to(dev)
    anchor_strides = torch.from_numpy(stride_np).to(dev)
    num_classes = cfg.model.head.num_classes
    K = cfg.dataset.max_labeled_frames
    bb = cfg.model.backbone
    in_res = bb.in_res_hw

    def train_step(lstm_states: LstmStates, ev_repr: torch.Tensor,
                   labels: torch.Tensor, label_mask: torch.Tensor,
                   frame_valid: torch.Tensor, is_first_sample: torch.Tensor,
                   token_mask: torch.Tensor | None = None):
        timers.mark("input")
        lstm_states = reset_states(
            tuple((h.detach().float(), c.detach().float())
                  for h, c in lstm_states), is_first_sample)
        ev_seq = window_seq(ev_repr, bb, torch.float32, plain)
        tm_seq = None
        if token_mask is not None:
            tm_seq = pad_token_mask(token_mask, in_res,
                                    bb.stem_patch_size).transpose(0, 1)
        model.train()  # BatchNorm on batch statistics
        optimizer.zero_grad()
        timers.mark("backbone")
        feats, final_states = scan_backbone(
            model, ev_seq, lstm_states, tm_seq, deterministic=False,
            remat=True, plain=plain)
        timers.mark("detect")
        gathered, frame_idx, gval = gather_labeled_frames(feats, frame_valid,
                                                          K)
        with batch_norm_group(group, plain=plain):
            preds = model.forward_detect(gathered)
        timers.mark("loss")
        targets, target_mask = gather_labels(labels.float(), label_mask,
                                             frame_idx)
        losses = yolox_loss(preds, targets, target_mask, gval.reshape(-1),
                            grid, anchor_strides, num_classes, group)
        timers.mark("detect_bwd")
        # the rest of the backward, once the neck's has reached the
        # backbone's features
        timers.mark_after_grads(gathered, "backbone_bwd")
        losses["loss"].backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            timers.mark("allreduce")
            optimizer.reduce_grads(group)
            parts = torch.stack([metrics[k] for k in LOSS_PARTS])
            dist.all_reduce(parts, group=group)
            metrics.update(zip(LOSS_PARTS, parts.unbind(0)))
        timers.mark("optimizer")
        if with_param_metrics:
            for name, p in model.named_parameters():
                metrics[f"gradflow/{name}"] = (
                    p.grad.abs().mean() if p.grad is not None
                    else torch.zeros((), device=p.device))
        metrics["grad_norm"] = optimizer.update()
        if with_param_metrics:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    metrics[f"weights/{name}"] = p.abs().mean()
        states = tuple((h.detach(), c.detach()) for h, c in final_states)
        if not with_detections:
            return states, metrics
        timers.mark("postprocess")
        with torch.no_grad():
            dets, det_valid = _postprocess_window(preds, frame_idx, gval,
                                                  cfg, plain)
        return states, metrics, (dets, det_valid, frame_idx, gval)

    step = CapturedStep(train_step, before=optimizer.load_scalars,
                        pool=graph_pool)
    eager = plain or (group is not None
                      and dist.get_backend(group) != "nccl")
    return step.run_eager if eager else step
