"""Label-aware spatial augmentation on padded window dicts (a copy of
``rvt_tpu.data.augmentor``).

Re-implements ``RandomSpatialAugmentorGenX`` (data/utils/augmentor.py:43-364)
in vectorised numpy on the dense window format:
  * h-flip (prob 0.5 in shipped configs),
  * rotation (NEAREST; prob 0 in shipped configs),
  * zoom-in: crop a window guaranteed to contain one GT box, rescale up
    (augmentor.py:182-249, 381-448) — random-sampling mode only,
  * zoom-out: shrink the canvas, paste at a random offset
    (augmentor.py:123-180).

Resizes use 'nearest-exact' semantics (src = floor((dst+0.5)*scale)),
matching torch ``interpolate(mode='nearest-exact')``. In stream mode the
augmentation state is sampled once per stream and re-applied to every
window (sequence_for_streaming.py:188-208); in random mode it is resampled
per sample.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from rvt_tpu_torch.config import DatasetConfig
from rvt_tpu_torch.data import labels as L
from rvt_tpu_torch.data.labels import pad_labels


def nearest_exact_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """[..., H, W] nearest-exact resize."""
    H, W = img.shape[-2:]
    oh, ow = out_hw
    ys = np.minimum((np.arange(oh) + 0.5) * (H / oh), H - 1).astype(np.int64)
    xs = np.minimum((np.arange(ow) + 0.5) * (W / ow), W - 1).astype(np.int64)
    return img[..., ys[:, None], xs[None, :]]


def rotate_nearest(img: np.ndarray, angle_deg: float) -> np.ndarray:
    """[..., H, W] rotation (counter-clockwise, nearest, zero fill) about
    the image centre."""
    H, W = img.shape[-2:]
    a = math.radians(angle_deg)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    # inverse mapping: rotate output coords by -angle
    xs = (xx - cx) * math.cos(a) - (yy - cy) * math.sin(a) + cx
    ys = (xx - cx) * math.sin(a) + (yy - cy) * math.cos(a) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi = np.clip(xi, 0, W - 1)
    yi = np.clip(yi, 0, H - 1)
    out = img[..., yi, xi]
    return np.where(valid, out, 0).astype(img.dtype)


@dataclass
class AugmentationState:
    h_flip: bool = False
    rotate_deg: Optional[float] = None
    zoom_in_factor: Optional[float] = None     # sampled per call (label-dependent window)
    zoom_out: Optional[Tuple[int, int, float]] = None  # (x0, y0, factor)


class SpatialAugmentor:
    """Stateless parameter container; sampling and application are explicit
    so stream lanes can pin a state across windows."""

    def __init__(self, dataset_hw: Tuple[int, int], prob_hflip: float = 0.5,
                 rotate_prob: float = 0.0, rotate_min_deg: float = 2.0,
                 rotate_max_deg: float = 6.0, zoom_prob: float = 0.8,
                 zoom_in_weight: float = 8.0, zoom_in_min: float = 1.0,
                 zoom_in_max: float = 1.5, zoom_out_weight: float = 2.0,
                 zoom_out_min: float = 1.0, zoom_out_max: float = 1.2):
        self.hw = dataset_hw
        self.prob_hflip = prob_hflip
        self.rotate_prob = rotate_prob
        self.rotate_min_deg = rotate_min_deg
        self.rotate_max_deg = rotate_max_deg
        self.zoom_prob = zoom_prob
        self.zoom_in_weight = zoom_in_weight
        self.zoom_in_range = (zoom_in_min, zoom_in_max)
        self.zoom_out_weight = zoom_out_weight
        self.zoom_out_range = (zoom_out_min, zoom_out_max)

    @staticmethod
    def for_mode(cfg: DatasetConfig, mode: str) -> "SpatialAugmentor":
        """Shipped augmentation presets (config/dataset/base.yaml)."""
        hw = cfg.dataloading_hw
        if mode == "random":
            return SpatialAugmentor(hw)
        assert mode == "stream"
        return SpatialAugmentor(hw, zoom_prob=0.5, zoom_in_weight=0.0,
                                zoom_out_weight=1.0)

    def sample_state(self, rng: random.Random,
                     allow_zoom_in: bool = True) -> AugmentationState:
        """Sample input-independent parameters (augmentor.py:89-121)."""
        st = AugmentationState()
        st.h_flip = rng.random() < self.prob_hflip
        if rng.random() < self.rotate_prob:
            sign = 1 if rng.random() < 0.5 else -1
            st.rotate_deg = sign * rng.uniform(self.rotate_min_deg, self.rotate_max_deg)
        do_zoom = rng.random() < self.zoom_prob
        w_in = self.zoom_in_weight if allow_zoom_in else 0.0
        w_out = self.zoom_out_weight
        total = w_in + w_out
        pick_in = total > 0 and rng.random() < (w_in / total)
        if do_zoom and pick_in:
            st.zoom_in_factor = rng.uniform(*self.zoom_in_range)
        elif do_zoom and w_out > 0:
            factor = rng.uniform(*self.zoom_out_range)
            h, w = self.hw
            zw_h, zw_w = int(h / factor), int(w / factor)
            x0 = int(rng.uniform(0, w - zw_w))
            y0 = int(rng.uniform(0, h - zw_h))
            st.zoom_out = (x0, y0, factor)
        return st

    # -- application ---------------------------------------------------------

    def apply(self, window: Dict[str, np.ndarray], state: AugmentationState,
              rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        ev = window["ev_repr"]  # [T, C, H, W]
        labels = window["labels"]
        mask = window["label_mask"]
        T, M = mask.shape
        hw = ev.shape[-2:]

        lab_list = [labels[t][mask[t]] for t in range(T)]

        if state.h_flip:
            ev = ev[..., ::-1]
            lab_list = [L.flip_lr(x, hw) for x in lab_list]
        if state.rotate_deg is not None:
            ev = rotate_nearest(ev, state.rotate_deg)
            lab_list = [L.rotate(x, hw, state.rotate_deg) for x in lab_list]
        if state.zoom_in_factor is not None and state.zoom_in_factor != 1.0:
            out = self._zoom_in(ev, lab_list, state.zoom_in_factor,
                                rng or random.Random(0))
            if out is not None:
                ev, lab_list = out
        elif state.zoom_out is not None and state.zoom_out[2] != 1.0:
            ev, lab_list = self._zoom_out(ev, lab_list, state.zoom_out)

        new_labels = np.zeros_like(labels)
        new_mask = np.zeros_like(mask)
        for t, lab in enumerate(lab_list):
            if len(lab):
                new_labels[t], new_mask[t] = pad_labels(lab, M)
        out_w = dict(window)
        out_w["ev_repr"] = np.ascontiguousarray(ev)
        out_w["labels"] = new_labels
        out_w["label_mask"] = new_mask
        out_w["frame_valid"] = new_mask.any(-1)
        return out_w

    def _zoom_in(self, ev, lab_list, factor, rng):
        """Crop a zoom window containing a random GT of the most recent
        labelled frame, then upscale (augmentor.py:182-221, 367-448)."""
        H, W = ev.shape[-2:]
        zw_h, zw_w = int(H / factor), int(W / factor)
        latest = next((x for x in reversed(lab_list) if len(x)), None)
        if latest is None:
            return None
        idx = rng.randrange(len(latest)) if len(latest) > 1 else 0
        x0l, y0l = latest[idx, L.L_X], latest[idx, L.L_Y]
        wl, hl = latest[idx, L.L_W], latest[idx, L.L_H]
        x1l, y1l = x0l + wl, y0l + hl
        x0v = max(x1l - max(zw_w, wl), 0)
        y0v = max(y1l - max(zw_h, hl), 0)
        x1v = min(x0l + max(zw_w, wl), W - 1)
        y1v = min(y0l + max(zw_h, hl), H - 1)
        x1v = max(x1v - zw_w, x0v)
        y1v = max(y1v - zw_h, y0v)
        x0 = int(rng.uniform(x0v, x1v))
        y0 = int(rng.uniform(y0v, y1v))
        crop = ev[..., y0:y0 + zw_h, x0:x0 + zw_w]
        ev = nearest_exact_resize(crop, (H, W))
        lab_list = [L.zoom_in_and_rescale(x, (H, W), (x0, y0), factor)
                    for x in lab_list]
        return ev, lab_list

    def _zoom_out(self, ev, lab_list, zoom_out):
        x0, y0, factor = zoom_out
        H, W = ev.shape[-2:]
        zw_h, zw_w = int(H / factor), int(W / factor)
        small = nearest_exact_resize(ev, (zw_h, zw_w))
        out = np.zeros_like(ev)
        out[..., y0:y0 + zw_h, x0:x0 + zw_w] = small
        lab_list = [L.zoom_out_and_rescale(x, (H, W), (x0, y0), factor)
                    for x in lab_list]
        return out, lab_list
