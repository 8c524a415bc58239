"""Validation/test CLI (port of ``rvt_tpu/cli/validate.py``).

Equivalent of upstream ``validation.py`` (validation.py:28-90): load a
checkpoint (an upstream Lightning ``.ckpt`` / ``.pt``, or a directory of
the port's Trainer checkpoints), run streaming evaluation over the val or
test split, print the Prophesee COCO metrics as JSON.

    python -m rvt_tpu_torch.cli.validate --dataset gen1 --size tiny \
        --data_dir /data/gen1 --checkpoint rvt-t.ckpt --use_test_set
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace
from pathlib import Path


def serve_fused_config(cfg):
    """The config on the serving kernels: bf16 compute, the s2d stem and
    ``fused_kernels``."""
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, stem_s2d=True,
                         fused_kernels=True)))


def load_model(checkpoint, cfg, device="cuda"):
    """A detector for ``cfg.model`` on ``device`` with the weights of
    ``checkpoint``: a ``.ckpt`` / ``.pt`` file in the upstream layout, or
    the directory of a ``CheckpointManager`` (its best slot when there is
    one, else its latest step, as the JAX CLI restores the best and falls
    back to the latest)."""
    from rvt_tpu_torch import resolve_device
    from rvt_tpu_torch.convert.torch_ckpt import load_torch_checkpoint
    from rvt_tpu_torch.models.detector import RVTDetector
    from rvt_tpu_torch.utils.checkpoint import CheckpointManager

    dev = resolve_device(device)
    model = RVTDetector(cfg.model)
    path = Path(checkpoint)
    if path.suffix in (".ckpt", ".pt"):
        load_torch_checkpoint(path, model)
    else:
        if not path.is_dir():
            raise FileNotFoundError(f"no checkpoint at {path}")
        mgr = CheckpointManager(path)
        state = mgr.restore_best(map_location="cpu")
        if state is None:
            state = mgr.restore(map_location="cpu")
        if state is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        model.load_state_dict(state["model"], strict=True)
    return model.to(dev).eval()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["gen1", "gen4"], required=True)
    ap.add_argument("--size", choices=["tiny", "small", "base"], default="tiny")
    ap.add_argument("--data_dir", type=Path, required=True)
    ap.add_argument("--checkpoint", type=Path, required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--use_test_set", action="store_true")
    ap.add_argument("--viz_dir", type=Path, default=None,
                    help="write pred-vs-GT panel PNGs here "
                         "(reference callbacks/detection.py:32-100)")
    ap.add_argument("--viz_every", type=int, default=50)
    ap.add_argument("--num_workers", type=int, default=0,
                    help="parallel input-pipeline fetch workers "
                         "(data/loader.py); 0 = serial")
    ap.add_argument("--loader_mode", choices=["thread", "process"],
                    default="thread")
    ap.add_argument("--serve_fused", action="store_true",
                    help="bf16 compute + the hand-written serving kernels "
                         "+ s2d stem. Default evaluates in f32 on the "
                         "module path, for strict checkpoint parity.")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    from rvt_tpu_torch.cli.train import build_streams
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval

    cfg = preset(args.dataset, args.size)
    if args.serve_fused:
        cfg = serve_fused_config(cfg)
    model = load_model(args.checkpoint, cfg, args.device)

    split = "test" if args.use_test_set else "val"
    streams = build_streams(args.data_dir, split, cfg)
    sched = EvalStreamScheduler(streams, args.batch_size)
    if args.num_workers:
        from rvt_tpu_torch.data.loader import ParallelBatchLoader

        sched = ParallelBatchLoader(sched, args.num_workers,
                                    mode=args.loader_mode)
    metrics = run_streaming_eval(model, cfg, iter(sched), args.batch_size,
                                 viz_dir=args.viz_dir,
                                 viz_every=args.viz_every,
                                 device=args.device)
    print(json.dumps(metrics, indent=2))


if __name__ == "__main__":
    main()
