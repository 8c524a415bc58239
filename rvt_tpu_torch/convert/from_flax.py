"""Weight bridge: the JAX package's flax variables -> the port's state_dict.

The inverse of ``rvt_tpu/convert/torch_ckpt.py:convert_state_dict``. It
takes the variables as nested dicts of numpy arrays (``params`` and
``batch_stats``) and returns tensors under the upstream PyTorch RVT names
that the port's modules use:

  backbone/stage{i}/downsample/{conv,norm}  -> backbone.stages.{i-1}.downsample_cf2cl.{conv,norm}
  backbone/stage{i}/block{j}/att_{window,grid}/
      (norm1|self_attn.qkv|self_attn.proj|ls1|norm2|mlp.fc1|mlp.glu.proj|mlp.fc2|ls2)
                                            -> ...att_blocks.{j}.att_*.(...|mlp.net.0.0|mlp.net.0.proj|mlp.net.2|...)
  backbone/stage{i}/lstm/{conv1x1,conv3x3_dws}
                                            -> backbone.stages.{i-1}.lstm.{conv1x1,conv3x3_dws}
  fpn/NAME/... (CSP members m{k})           -> fpn.NAME.... (m.{k})
  head/stem{k}                              -> yolox_head.stems.{k}
  head/{cls,reg}_conv{k}_{j}                -> yolox_head.{cls,reg}_convs.{k}.{j}
  head/{cls,reg,obj}_pred{k}                -> yolox_head.{cls,reg,obj}_preds.{k}

Layouts: conv HWIO -> OIHW (depthwise [k,k,1,C] -> [C,1,k,k]); dense
[in, out] -> linear [out, in]; LayerNorm/BatchNorm scale -> weight;
batch_stats mean/var -> running_mean/running_var (and a zero
``num_batches_tracked`` per BatchNorm).
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


# flax leaf name -> torch leaf name
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "gamma": "gamma", "mean": "running_mean", "var": "running_var"}


def _attention(rest: Tuple[str, ...], v: np.ndarray):
    mod, leaf = rest[:-1], rest[-1]
    names = {("self_attn", "qkv"): "self_attn.qkv",
             ("self_attn", "proj"): "self_attn.proj",
             ("mlp", "fc1"): "mlp.net.0.0", ("mlp", "fc2"): "mlp.net.2",
             ("mlp", "glu", "proj"): "mlp.net.0.proj",
             ("norm1",): "norm1", ("norm2",): "norm2", ("ls1",): "ls1",
             ("ls2",): "ls2"}
    if mod not in names:
        raise KeyError(f"unhandled attention parameter {rest}")
    if leaf == "kernel":
        v = v.T
    return f"{names[mod]}.{_LEAF[leaf]}", v


def _backbone(path: Tuple[str, ...], v: np.ndarray):
    stage = int(re.fullmatch(r"stage(\d+)", path[0]).group(1)) - 1
    pre = f"backbone.stages.{stage}."
    rest = path[1:]
    if rest == ("mask_token",):
        return pre + "mask_token", v
    if rest[0] == "downsample":
        if rest[1] == "conv":
            return pre + "downsample_cf2cl.conv.weight", _conv(v)
        return pre + f"downsample_cf2cl.norm.{_LEAF[rest[2]]}", v
    m = re.fullmatch(r"block(\d+)", rest[0])
    if m:
        key, v = _attention(rest[2:], v)
        return pre + f"att_blocks.{m.group(1)}.{rest[1]}.{key}", v
    if rest[0] == "lstm" and rest[1] in ("conv1x1", "conv3x3_dws"):
        return (pre + f"lstm.{rest[1]}.{_LEAF[rest[2]]}",
                _conv(v) if rest[2] == "kernel" else v)
    raise KeyError(f"unhandled backbone parameter {path}")


def _module_path(parts: Tuple[str, ...]) -> str:
    """fpn/head sub-module names: CSP members ``m{k}`` -> ``m.{k}``."""
    return ".".join(re.sub(r"^m(\d+)$", r"m.\1", p) for p in parts)


def _neck_head(path: Tuple[str, ...], v: np.ndarray):
    leaf = path[-1]
    if path[0] == "fpn":
        key = "fpn." + _module_path(path[1:-1])
    else:
        m = re.fullmatch(r"(cls|reg|obj)_pred(\d+)", path[1])
        if m:
            key = f"yolox_head.{m.group(1)}_preds.{m.group(2)}"
            return (f"{key}.{_LEAF[leaf]}",
                    _conv(v) if leaf == "kernel" else v)
        m = re.fullmatch(r"stem(\d+)", path[1])
        m2 = re.fullmatch(r"(cls|reg)_conv(\d+)_(\d+)", path[1])
        if m:
            head = f"yolox_head.stems.{m.group(1)}"
        elif m2:
            head = f"yolox_head.{m2.group(1)}_convs.{m2.group(2)}.{m2.group(3)}"
        else:
            raise KeyError(f"unhandled head parameter {path}")
        key = ".".join([head] + ([_module_path(path[2:-1])]
                                 if path[2:-1] else []))
    return (f"{key}.{_LEAF[leaf]}",
            _conv(v) if leaf == "kernel" else v)


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (nested dicts of arrays) -> the
    port's ``state_dict`` (f32 tensors). Every key is assigned once."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, v: np.ndarray) -> None:
        if key in out:
            raise KeyError(f"duplicate key {key}")
        out[key] = torch.from_numpy(np.array(v, np.float32))

    for path, v in _flatten(variables["params"]):
        if path[0] == "backbone":
            put(*_backbone(path[1:], v))
        elif path[0] in ("fpn", "head"):
            put(*_neck_head(path, v))
        else:
            raise KeyError(f"unhandled parameter {path}")
    for path, v in _flatten(variables.get("batch_stats", {})):
        key, v = _neck_head(path, v)
        put(key, v)
        if key.endswith(".running_mean"):
            out[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.zeros((), dtype=torch.long))
    return out
