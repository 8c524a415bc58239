"""The program under test: the port's configuration and model for a
benchmark configuration, with the harness's weights.

The benchmark configuration names the port's preset and the choices the
program takes on top of it (compute dtype, the hand-written kernels, the
postprocess); the cell adds its input layout (``stem_s2d``). The port's
derived numbers are checked against the architecture the configuration
file states, which is what the reference builds: a configuration that
drifted from the file fails before any run.
"""
from __future__ import annotations

from dataclasses import replace

import torch


def port_config(cfg: dict, stem_s2d: bool):
    from rvt_tpu_torch.config import preset

    dataset, size = cfg["preset"]
    pc = preset(dataset, size, **cfg.get("dataset_overrides", {}))
    prog = cfg["program"]
    pc = replace(pc, model=replace(
        pc.model, compute_dtype=prog["compute_dtype"],
        backbone=replace(pc.model.backbone,
                         fused_kernels=prog["fused_kernels"],
                         stem_s2d=stem_s2d),
        postprocess=replace(pc.model.postprocess, **cfg["postprocess"])))
    check_config(cfg, pc)
    return pc


def check_config(cfg: dict, pc) -> None:
    """The port's derived configuration against the file's numbers."""
    bb, A = pc.model.backbone, cfg["model"]
    att = bb.attention
    got = {"input_channels": bb.input_channels, "embed_dim": bb.embed_dim,
           "dim_multiplier": list(bb.dim_multiplier),
           "stem_patch_size": bb.stem_patch_size, "dim_head": att.dim_head,
           "mlp_ratio": att.mlp_ratio, "norm_eps": att.norm_eps,
           "fpn_depth": pc.model.fpn.depth,
           "fpn_in_stages": list(pc.model.fpn.in_stages),
           "num_classes": pc.model.head.num_classes,
           "resolution_hw": list(pc.dataset.resolution_hw),
           "in_res_hw": list(bb.in_res_hw),
           "partition_size": list(att.partition_size),
           "sequence_length": pc.dataset.sequence_length,
           "max_labeled_frames": pc.dataset.max_labeled_frames,
           "max_labels_per_frame": pc.dataset.max_labels_per_frame}
    bad = {k: (v, A.get(k)) for k, v in got.items() if A.get(k) != v}
    tr = pc.training
    got_t = {"learning_rate": tr.learning_rate,
             "weight_decay": tr.weight_decay,
             "gradient_clip_val": tr.gradient_clip_val,
             "div_factor": tr.lr_scheduler.div_factor,
             "final_div_factor": tr.lr_scheduler.final_div_factor,
             "pct_start": tr.lr_scheduler.pct_start,
             "total_steps": tr.lr_scheduler.total_steps}
    bad.update({k: (v, cfg["training"].get(k)) for k, v in got_t.items()
                if cfg["training"].get(k) != v})
    if bad:
        raise ValueError(f"the port's configuration differs from "
                         f"{cfg['name']}.json (port, file): {bad}")


def port_model(pc, state_dict, device):
    """The port's detector on ``device`` with ``state_dict`` loaded."""
    from rvt_tpu_torch.models.detector import RVTDetector

    with torch.device("meta"):
        model = RVTDetector(pc.model)
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()
