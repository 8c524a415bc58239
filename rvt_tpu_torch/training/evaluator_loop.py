"""Streaming evaluation loop: batches -> eval step -> Prophesee COCO
metrics.

Port of ``rvt_tpu/training/evaluator_loop.py``, the equivalent of
upstream ``validation.py`` + ``Module._val_test_step_impl`` +
``Module.run_psee_evaluator`` (modules/detection.py:208-338): runs the
recurrent model over every recording with carried LSTM states, collects
detections at labelled frames, and evaluates with the Prophesee protocol.
In data parallelism each process evaluates its shard of the recordings
and the evaluators are merged before scoring
(``parallel/multihost.py:merge_evaluator_buffers``), so every process
scores the identical full set; in one process the merge does nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.config import ExperimentConfig
from rvt_tpu_torch.data.types import Batch
from rvt_tpu_torch.evaluation.prophesee import (PropheseeEvaluator,
                                                detections_to_structured,
                                                labels_to_structured)
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import RVTDetector
from rvt_tpu_torch.parallel.multihost import merge_evaluator_buffers
from rvt_tpu_torch.training.feed import (PinnedFeed, stored_layout,
                                         window_input)
from rvt_tpu_torch.training.step import make_eval_step
from rvt_tpu_torch.utils import timers
from rvt_tpu_torch.utils.visualization import (LABELMAP_GEN1,
                                               LABELMAP_GEN4_SHORT,
                                               render_detections)


def labelmap_of(cfg: ExperimentConfig):
    return (LABELMAP_GEN4_SHORT if cfg.dataset.name == "gen4"
            else LABELMAP_GEN1)


def _write_panel(path, ev_hwc: np.ndarray, gt, pred, labelmap) -> None:
    """Render one labelled frame ([H, W, C] uint8 storage layout) with GT
    and prediction overlays and save it as PNG."""
    from PIL import Image

    img = render_detections(np.moveaxis(ev_hwc, -1, 0), gt, pred, labelmap)
    Image.fromarray(img).save(str(path))


def iter_batch_detections(batch: Batch, dets: np.ndarray,
                          det_valid: np.ndarray, frame_idx: np.ndarray,
                          gval: np.ndarray):
    """Convert one window's step outputs to Prophesee-protocol arrays.

    Yields (lane, t_step, gt, pred) for every labelled frame: gt/pred are
    BBOX_DTYPE structured arrays stamped with the label frame's time
    (reference to_prophesee, io/box_loading.py:58-99). Shared by the
    streaming eval loop and the trainer's train-time detection metrics."""
    for b in range(batch.batch_size):
        for k in range(frame_idx.shape[1]):
            if not gval[b, k]:
                continue
            t_step = int(frame_idx[b, k])
            mask = batch.label_mask[b, t_step]
            labels = batch.labels[b, t_step][mask]
            if len(labels) == 0:
                continue
            time_us = int(labels[0, 0])
            gt = labels_to_structured(labels)
            pred = detections_to_structured(dets[b, k], det_valid[b, k],
                                            time_us)
            yield b, t_step, gt, pred


def fetch_outputs(outputs, device: torch.device
                  ) -> Callable[[], List[np.ndarray]]:
    """Start the host copy of step outputs; returns a function that waits
    for it and gives numpy arrays. On a card the copies go to pinned
    memory right behind the step that made them, so a wait begun after
    the next window's step has been launched does not queue behind it.
    The start is the span ``eval.fetch``; the wait is the caller's."""
    if device.type != "cuda":
        arrays = [o.numpy() for o in outputs]
        return lambda: arrays
    with timers.span("eval.fetch", device):
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outputs]
        for h, o in zip(host, outputs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

    def wait() -> List[np.ndarray]:
        done.synchronize()
        return [h.numpy() for h in host]

    return wait


def run_streaming_eval(model: RVTDetector, cfg: ExperimentConfig,
                       batches: Iterable[Batch], batch_size: int,
                       viz_dir=None, viz_every: int = 50,
                       device="cuda") -> Optional[Dict[str, float]]:
    """Evaluate ``model`` (on ``device``) over an iterable of stream
    batches, all of ``batch_size`` lanes.

    Returns the Prophesee COCO metrics dict or None if no labels were
    seen; with several processes, those of every process's batches (each
    process calls this on its shard, and all get the same metrics). The
    eval step is made here, from the weights the model has now (the
    kernels' weights are prepared once per call). Each window reaches
    the card through the pinned feed (``training/feed.py``) in its stored
    layout and is laid out (and s2d-blocked) there.

    viz_dir: if set, writes a pred-vs-GT panel PNG for every viz_every-th
    labelled frame (reference DetectionVizCallback image grids,
    callbacks/detection.py:32-100)."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type or (dev.index is not None
                                      and model_dev != dev):
        raise ValueError(f"the model lives on {model_dev}, not on {dev}")
    eval_step = make_eval_step(model, cfg)
    evaluator = PropheseeEvaluator(cfg.dataset.name,
                                   cfg.dataset.downsample_by_factor_2)
    states = zero_states(cfg.model.backbone, batch_size, device=model_dev)
    stem_s2d = model.cfg.backbone.stem_s2d
    in_res = cfg.model.backbone.in_res_hw
    feed = PinnedFeed(model_dev)
    if viz_dir is not None:
        from pathlib import Path

        viz_dir = Path(viz_dir)
        viz_dir.mkdir(parents=True, exist_ok=True)
        labelmap = labelmap_of(cfg)
    frames_seen = 0

    def consume(batch: Batch, fetch) -> None:
        """Convert one window's step outputs to protocol arrays (host)."""
        nonlocal frames_seen
        gt_list, pred_list = [], []
        for b, t_step, gt, pred in iter_batch_detections(batch, *fetch()):
            gt_list.append(gt)
            pred_list.append(pred)
            if viz_dir is not None and frames_seen % viz_every == 0:
                _write_panel(viz_dir / f"frame_{frames_seen:06d}.png",
                             batch.ev_repr[b, t_step], gt, pred, labelmap)
            frames_seen += 1
        if gt_list:
            evaluator.add_labels(gt_list)
            evaluator.add_predictions(pred_list)

    # one-window lag: window N is converted after window N+1's step
    pending = None
    K = cfg.dataset.max_labeled_frames
    for batch in batches:
        assert batch.batch_size == batch_size
        # gather_labeled_frames drops labelled frames beyond K; in eval
        # that would leave GT frames without predictions and skew the
        # protocol metric. A ValueError, not an assert: it must survive
        # `python -O`.
        n_lab = int(batch.frame_valid.sum(axis=1).max())
        if n_lab > K:
            raise ValueError(
                f"window has {n_lab} labelled frames > max_labeled_frames="
                f"{K}; raise DatasetConfig.max_labeled_frames")
        ev, stored = stored_layout(batch.ev_repr)
        ev, frame_valid, is_first = feed(
            [ev, batch.frame_valid, batch.is_first_sample])
        out = eval_step(states, window_input(ev, stored, in_res, stem_s2d),
                        frame_valid, is_first)
        states = out.states
        fetch = fetch_outputs(
            (out.dets, out.det_valid, out.frame_idx, out.gval), model_dev)
        if pending is not None:
            consume(*pending)
        pending = (batch, fetch)
    if pending is not None:
        consume(*pending)

    # every process's shard, so that all score the identical full set
    # (the reference reduces the metric across ranks instead,
    # modules/detection.py:319-334)
    merge_evaluator_buffers(evaluator)

    if not evaluator.has_data():
        return None
    h, w = cfg.dataset.dataloading_hw
    return evaluator.evaluate_buffer(img_height=h, img_width=w)
