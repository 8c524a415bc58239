"""Load upstream RVT checkpoints into the port's detector.

Port of ``rvt_tpu/convert/torch_ckpt.py:load_torch_checkpoint``. The
upstream model is a PyTorch module tree, and the port's ``RVTDetector``
keeps its names (``backbone.stages.{i}...``, ``fpn...``,
``yolox_head...``) and layouts (OIHW convs, [out, in] linears), so a
checkpoint loads as it is: a PyTorch-Lightning ``.ckpt`` holds the
weights under ``state_dict`` with the ``mdl.`` prefix
(upstream ``modules/detection.py:33``), a ``.pt`` may be that dict or the
bare state dict. Loading is strict: a key the model does not take, or one
it misses, raises, as the JAX converter raises ``KeyError`` on a key it
does not handle.
"""
from __future__ import annotations

from typing import Mapping

import torch

from rvt_tpu_torch.models.detector import RVTDetector

PREFIX = "mdl."


def load_torch_checkpoint(path, model: RVTDetector) -> RVTDetector:
    """Load the upstream checkpoint at ``path`` into ``model`` (on its
    device, in its parameters' dtypes) and return the model."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, Mapping) else ckpt
    if not isinstance(sd, Mapping):
        raise TypeError(f"{path}: not a state dict ({type(sd).__name__})")
    model.load_state_dict({(k[len(PREFIX):] if k.startswith(PREFIX) else k):
                           v for k, v in sd.items()}, strict=True)
    return model
