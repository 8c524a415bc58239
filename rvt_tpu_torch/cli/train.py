"""Training CLI (port of ``rvt_tpu/cli/train.py``).

Equivalent of the reference ``train.py`` (hydra main, train.py:32-142) with
argparse + dataclass presets instead of hydra composition, on the port's
``Trainer``:

    python -m rvt_tpu_torch.cli.train --dataset gen1 --size base \
        --data_dir /data/gen1 --ckpt_dir runs/gen1_base

``--data_dir`` holds the ``train`` and ``val`` splits that
``python -m rvt_tpu_torch.cli.preprocess`` writes. The train sampler
follows the preset's ``train_sampling`` (stream lanes, random-access
lanes, or both: ``mixed``, modules/data/genx.py:116-140) with the
shipped spatial augmentation; validation runs every ``--val_every`` steps
on the val split. ``build_train_scheduler`` and ``make_eval_fn`` take
recordings and streams already opened, so that a caller can feed them
from memory. The run is on ``--device`` (``cuda`` by default; no card
raises). Data parallelism, one process a card, launched by torchrun:

    torchrun --nproc_per_node=N -m rvt_tpu_torch.cli.train --multihost \
        --dataset gen1 --size base --data_dir /data/gen1 ...

``--multihost`` joins the process group from torchrun's environment and
puts each rank on ``cuda:LOCAL_RANK`` (NCCL; ranks sharing a card, or
``--device cpu``, go over gloo); every rank samples the identical global
batches and trains on its lanes, and validation evaluates each rank's
shard of the recordings, merged before scoring.
"""
from __future__ import annotations

import argparse
from dataclasses import replace
from pathlib import Path


def open_recordings(data_dir: Path, split: str, cfg):
    """One ``Recording`` per recording directory under
    ``<data_dir>/<split>``, in name order."""
    from rvt_tpu_torch.data.sequence import Recording

    split_dir = Path(data_dir) / split
    if not split_dir.is_dir():
        raise FileNotFoundError(f"no {split} split at {split_dir}")
    return [Recording(rec_dir, cfg.dataset.ev_repr_name,
                      original_hw=cfg.dataset.resolution_hw,
                      downsample_by_factor_2=cfg.dataset.downsample_by_factor_2,
                      max_labels_per_frame=cfg.dataset.max_labels_per_frame)
            for rec_dir in sorted(p for p in split_dir.iterdir()
                                  if p.is_dir())]


def build_streams(data_dir: Path, split: str, cfg):
    """One ``StreamView`` per recording under ``<data_dir>/<split>`` (the
    evaluation streams; ``build_train_scheduler`` cuts the training ones
    into label-dense sub-streams)."""
    from rvt_tpu_torch.data.sequence import StreamView

    return [StreamView(rec, cfg.dataset.sequence_length)
            for rec in open_recordings(data_dir, split, cfg)]


def build_train_scheduler(cfg, recordings, seed: int = 0,
                          num_workers: int = 0, loader_mode: str = "thread"):
    """The train batches of ``recordings`` as ``cfg.dataset.train_sampling``
    asks: ``stream`` lanes (the label-dense sub-streams, augmentation drawn
    once a stream), ``random`` lanes (windows ending at a labelled frame,
    augmentation drawn per sample, the LSTM state reset every batch) or
    ``mixed``: ``split_batch_size`` stream lanes first, then random lanes,
    the stream lanes seeded by ``seed`` and the random ones by
    ``seed + 1``. With ``num_workers``, windows are fetched by a
    ``ParallelBatchLoader`` pool; its batches equal the serial ones."""
    from rvt_tpu_torch.data.augmentor import SpatialAugmentor
    from rvt_tpu_torch.data.random_access import (MixedScheduler,
                                                  RandomAccessScheduler,
                                                  split_batch_size)
    from rvt_tpu_torch.data.sequence import RandomAccessView, StreamView
    from rvt_tpu_torch.data.streaming import TrainStreamScheduler

    ds = cfg.dataset
    B = cfg.batch_size.train
    streams = [s for rec in recordings
               for s in StreamView.with_guaranteed_labels(
                   rec, ds.sequence_length)]
    stream_augment = SpatialAugmentor.for_mode(ds, "stream")
    sampling = ds.train_sampling
    if sampling == "stream":
        scheduler = TrainStreamScheduler(streams, B, seed=seed,
                                         augment_fn=stream_augment)
    else:
        rnd_views = [RandomAccessView(
            rec, ds.sequence_length,
            only_load_end_labels=ds.only_load_end_labels)
            for rec in recordings]
        rnd_augment = SpatialAugmentor.for_mode(ds, "random")
        if sampling == "random":
            scheduler = RandomAccessScheduler(rnd_views, B, seed=seed,
                                              augment_fn=rnd_augment)
        elif sampling == "mixed":  # reference w_stream=1, w_random=1
            n_stream, n_random = split_batch_size(B)
            scheduler = MixedScheduler(
                TrainStreamScheduler(streams, n_stream, seed=seed,
                                     augment_fn=stream_augment),
                RandomAccessScheduler(rnd_views, n_random, seed=seed + 1,
                                      augment_fn=rnd_augment))
        else:
            raise ValueError(f"unknown train_sampling {sampling!r}")
    if num_workers:
        from rvt_tpu_torch.data.loader import ParallelBatchLoader

        scheduler = ParallelBatchLoader(scheduler, num_workers,
                                        mode=loader_mode)
    return scheduler


def make_eval_fn(cfg, val_streams, num_workers: int = 0,
                 loader_mode: str = "thread", device="cuda"):
    """``eval_fn(model)`` for ``Trainer.fit``: the streaming evaluation of
    ``model`` over this process's shard of ``val_streams`` (every stream
    in one process; the rank's share in data parallelism, as JAX's CLI
    shards them), returning the Prophesee metrics of every shard (the
    loop merges the processes' evaluators)."""
    from rvt_tpu_torch.data.loader import make_loader
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.parallel.mesh import make_mesh
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval

    B = cfg.batch_size.eval

    def eval_fn(model):
        # shard recordings across processes (reference: rank-aware
        # stream sharding, stream_sharded_datapipe.py:73-80)
        mesh = make_mesh()
        sched = EvalStreamScheduler(val_streams, B, shard_index=mesh.rank,
                                    num_shards=mesh.world)
        batches = make_loader(sched, num_workers, mode=loader_mode)
        return run_streaming_eval(model, cfg, iter(batches), B,
                                  device=device)

    return eval_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["gen1", "gen4"], required=True)
    ap.add_argument("--size", choices=["tiny", "small", "base"], default="tiny")
    ap.add_argument("--data_dir", type=Path, required=True)
    ap.add_argument("--ckpt_dir", type=Path, default=Path("runs/default"))
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--val_every", type=int, default=None)
    ap.add_argument("--log_every", type=int, default=500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp_size", type=int, default=-1,
                    help="data-parallel processes (-1: the world's size; "
                         "another value than it raises)")
    ap.add_argument("--num_workers", type=int, default=0,
                    help="input-pipeline fetch workers (reference "
                         "hardware.num_workers, modules/data/genx.py:92); "
                         "0 = serial")
    ap.add_argument("--loader_mode", choices=["thread", "process"],
                    default="thread")
    ap.add_argument("--multihost", action="store_true",
                    help="data-parallel training launched by torchrun: "
                         "join the process group from its environment, "
                         "one rank a card (cuda:LOCAL_RANK)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init_ckpt", type=Path, default=None,
                    help="upstream torch .ckpt for weights-only init, "
                         "loaded strictly (use --resume for the Trainer's "
                         "checkpoints)")
    ap.add_argument("--artifact_dir", type=Path, default=None,
                    help="checkpoint-artifact registry root (shared "
                         "storage); publishes scored checkpoints with "
                         "best/last aliases + a code snapshot (reference "
                         "W&B log_model)")
    ap.add_argument("--artifact_name", default="checkpoint")
    ap.add_argument("--artifact_top_k", type=int, default=1)
    ap.add_argument("--resume_artifact", default=None,
                    help="resume from a registry artifact URI, e.g. "
                         "'checkpoint@best' or 'checkpoint@v3' (requires "
                         "--artifact_dir)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    if args.resume_artifact and args.artifact_dir is None:
        ap.error("--resume_artifact requires --artifact_dir")

    from rvt_tpu_torch import resolve_device

    device = resolve_device(args.device)
    if not args.multihost:
        train(args, device)
        return
    import torch.distributed as dist

    from rvt_tpu_torch.parallel.mesh import init_process_group

    device = init_process_group(device)
    try:
        train(args, device)
    finally:
        dist.destroy_process_group()


def train(args, device) -> None:
    """The run ``main``'s arguments ask for, on ``device``."""
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = preset(args.dataset, args.size)
    if args.batch_size:
        cfg = replace(cfg, batch_size=replace(cfg.batch_size,
                                              train=args.batch_size,
                                              eval=args.batch_size))
    tcfg = TrainerConfig(
        max_steps=args.max_steps or cfg.training.max_steps,
        log_every_n_steps=args.log_every,
        val_every_n_steps=args.val_every,
        ckpt_dir=str(args.ckpt_dir),
        artifact_dir=(str(args.artifact_dir)
                      if args.artifact_dir is not None else None),
        artifact_name=args.artifact_name,
        artifact_top_k=args.artifact_top_k,
    )

    trainer = Trainer(cfg, tcfg, seed=args.seed, dp_size=args.dp_size,
                      device=device)
    if args.resume_artifact:
        if not trainer.restore_from_artifact(args.resume_artifact):
            raise RuntimeError("artifact restore failed")
    elif args.resume:
        if not trainer.restore():
            raise FileNotFoundError(
                f"no checkpoint to resume from in {args.ckpt_dir}")
    elif args.init_ckpt is not None:
        from rvt_tpu_torch.convert.torch_ckpt import load_torch_checkpoint

        load_torch_checkpoint(args.init_ckpt, trainer.model)
        trainer.replicate(optimizer=False)

    scheduler = build_train_scheduler(
        cfg, open_recordings(args.data_dir, "train", cfg), seed=args.seed,
        num_workers=args.num_workers, loader_mode=args.loader_mode)
    eval_fn = None
    if args.val_every:
        eval_fn = make_eval_fn(
            cfg, build_streams(args.data_dir, "val", cfg),
            args.num_workers, args.loader_mode, device)

    metrics = trainer.fit(iter(scheduler), eval_fn=eval_fn)
    print({k: round(v, 5) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
