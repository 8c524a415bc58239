"""The model's weights, made on the card from the seed: one upstream-named
state dict that the program and the reference both load.

The layout comes from the reference (``reference/rvt.py:specs``). Every
kernel is drawn in one call of a ``torch.Generator`` on the device
(lecun-normal, truncated at two deviations: std = 1 / sqrt(fan in) /
0.8796), LayerScale's gammas in a second (N(0, 0.1): large enough that
the attention branches shape the output, as a trained model's do), and
the rest is set: norms and BatchNorm at the identity, biases zero, the
head's class and objectness biases at YOLOX's prior: a model as training
starts it.

A cell that serves detections stands for a trained model, which finds
tens of candidates a frame and whose boxes overlap, so that NMS works.
Its workload file says so under ``weights`` (``trained_head``):

- ``bn_var``: the running variance of the PAFPN's and the head's
  BatchNorms, where a trained network's statistics keep the signal's
  scale from layer to layer (a random one's identity statistics shrink
  it at every SiLU);
- ``pred_gain``: the scale of the objectness and class kernels' draw, so
  that the logits spread over anchors as a trained head's do;
- ``obj_bias``, ``cls_bias``: ranges the objectness and class biases
  are drawn from, uniformly, a level and a class each, from the seed;
- ``wh_bias``: the box size's bias (log of the size over the stride).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import rvt

GAMMA_STD = 0.1
TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one purpose (``stream``) of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def make_state_dict(A: dict, seed: int, device, weights: dict = None
                    ) -> Dict[str, torch.Tensor]:
    spec = rvt.specs(A)
    g = generator(seed, device, 0)
    kernels = [(n, s) for n, s, how in spec if how == "kernel"]
    total = sum(math.prod(s) for _, s in kernels)
    flat = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    gammas = [(n, s) for n, s, how in spec if how == "gamma"]
    gflat = torch.randn(sum(math.prod(s) for _, s in gammas), generator=g,
                        device=device) * GAMMA_STD
    sd, off, goff = {}, 0, 0
    for name, shape, how in spec:
        n = math.prod(shape)
        if how == "kernel":
            fan_in = n // shape[0]
            sd[name] = flat[off:off + n].view(shape) * (
                fan_in ** -0.5 / TRUNC)
            off += n
        elif how == "gamma":
            sd[name] = gflat[goff:goff + n].view(shape)
            goff += n
        elif how == "count":
            sd[name] = torch.zeros((), dtype=torch.int64, device=device)
        else:
            value = {"zero": 0.0, "one": 1.0, "prior": rvt.PRIOR_LOGIT}[how]
            sd[name] = torch.full(shape, value, device=device)
    if weights and "trained_head" in weights:
        trained_head(sd, weights["trained_head"],
                     generator(seed, device, 3))
    return sd


def trained_head(sd: Dict[str, torch.Tensor], t: dict,
                 g: torch.Generator) -> None:
    """The head of a trained model, in place (the module's docstring)."""
    for name, v in sd.items():
        if name.startswith(("fpn.", "yolox_head.")) and name.endswith(
                "running_var"):
            v.fill_(t["bn_var"])
    for k in range(3):
        for pred, key in (("obj_preds", "obj_bias"), ("cls_preds",
                                                      "cls_bias")):
            sd[f"yolox_head.{pred}.{k}.weight"].mul_(t["pred_gain"])
            b = sd[f"yolox_head.{pred}.{k}.bias"]
            lo, hi = t[key]
            b.copy_(lo + (hi - lo) * torch.rand(b.shape, generator=g,
                                                device=b.device))
        sd[f"yolox_head.reg_preds.{k}.bias"][2:].fill_(t["wh_bias"])


def trainable(A: dict):
    """The names of the leaves training updates (not BatchNorm's
    buffers)."""
    return [n for n, _, how in rvt.specs(A)
            if not n.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]
