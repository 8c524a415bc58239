"""Training orchestration: TBPTT steps over a stream of batches, metrics,
checkpoint/resume, artifacts, periodic validation.

Port of ``rvt_tpu/training/trainer.py`` (the reference's Lightning stack:
``train.py`` + ``modules/detection.py`` + callbacks) as a plain loop
around the port's train step, on one GPU or data-parallel over processes
(one a card, ``parallel/mesh.py``). Checkpoints are ``torch.save``
files (``utils/checkpoint.py``), metrics a JSONL stream
(``utils/logging.py``), published checkpoints a filesystem registry
(``utils/artifacts.py``), pred-vs-GT panels of the training batches
(``utils/visualization.py``). On a card the train step and its variants
are captured CUDA graphs sharing one memory pool, and each batch reaches
the card through the pinned feed (``training/feed.py``) in its stored
layout, laid out (and s2d-blocked) there.

Data parallelism, as the JAX package's trainer over its dp mesh: every
process iterates the identical global batches and trains on its lanes of
each (the train step computes the global-batch step); the replicas are
broadcast from rank 0 after init and every load; the train-time
evaluator takes the rank's lanes and is merged over the processes before
it scores; rank 0 alone writes the code snapshot, checkpoints,
publishes, panels and the metrics file, and every rank computes the
same validation metric (``eval_fn`` merges its evaluator), so retention
agrees.
"""
from __future__ import annotations

import shutil
import time
from dataclasses import dataclass, fields, replace
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from rvt_tpu_torch.config import ExperimentConfig
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.data.prefetch import PrefetchIterator
from rvt_tpu_torch.data.types import Batch
from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import RVTDetector, init_detector
from rvt_tpu_torch.parallel.mesh import (make_mesh, module_tensors,
                                         replicate_tree)
from rvt_tpu_torch.parallel.multihost import merge_evaluator_buffers
from rvt_tpu_torch.training.evaluator_loop import (_write_panel,
                                                   iter_batch_detections,
                                                   labelmap_of)
from rvt_tpu_torch.training.feed import (PinnedFeed, stored_layout,
                                         window_input)
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import make_train_step
from rvt_tpu_torch.utils.artifacts import ArtifactRegistry, _file_manifest
from rvt_tpu_torch.utils.checkpoint import CheckpointManager
from rvt_tpu_torch.utils.logging import MetricsLogger


@dataclass
class TrainerConfig:
    max_steps: int = 400_000
    log_every_n_steps: int = 500
    ckpt_every_n_steps: int = 10_000
    val_every_n_steps: Optional[int] = None
    ckpt_dir: str = "checkpoints"
    # checkpoint selection metric, one to MAXIMISE (val/AP,
    # callbacks/custom.py:8-31): the best checkpoint and the artifact
    # registry's top-k keep the highest values
    monitor: str = "AP"
    # per-parameter mean-|grad| and mean-|w| logging cadence (reference
    # GradFlowLogCallback, callbacks/gradflow.py:10-51); 0 disables
    gradflow_every_n_steps: int = 5_000
    # input-pipeline lookahead: a background thread produces batches;
    # 0 disables
    prefetch_depth: int = 4
    # train-time detection metrics (reference
    # train_metrics_config.detection_metrics_every_n_steps,
    # modules/detection.py:199-205): every N steps, score the Prophesee
    # COCO metric on the training batches' detections of the last
    # detection_metrics_n_batches steps and log train/AP; 0 disables
    detection_metrics_every_n_steps: int = 0
    detection_metrics_n_batches: int = 4
    # pred-vs-GT panels from the training batch at every detection-metric
    # evaluation (reference DetectionVizCallback on train outputs,
    # callbacks/detection.py:32-100); None disables
    train_viz_dir: Optional[str] = None
    train_viz_max_panels: int = 4
    # checkpoint-artifact registry (reference W&B log_model=True,
    # wandb_logger.py:254-320); None disables
    artifact_dir: Optional[str] = None
    artifact_name: str = "checkpoint"
    artifact_top_k: int = 1


class Trainer:
    """Trains ``model`` (by default a new detector with random weights from
    ``seed``, its compute dtype from ``training.precision``) on
    ``device``, on the kernels or the modules as ``scan_backbone``
    routes the config. Dropout rates above 0 raise, as in
    ``make_train_step``. ``dp_size`` counts the data-parallel processes
    (``parallel/mesh.py:make_mesh``): -1 takes the process group's world
    (one process without a group); another value than the world's size
    raises."""

    def __init__(self, cfg: ExperimentConfig, trainer_cfg: TrainerConfig,
                 model: Optional[RVTDetector] = None, seed: int = 0,
                 dp_size: int = -1, device="cuda"):
        self.mesh = make_mesh(dp_size)
        self.cfg = cfg
        self.tcfg = trainer_cfg
        if model is None:
            compute = ("bfloat16" if cfg.training.precision in
                       ("bf16", "bfloat16") else "float32")
            model = init_detector(replace(cfg.model, compute_dtype=compute),
                                  seed=seed, device=device)
        self.model = model
        self.device = next(model.parameters()).device
        self.optimizer = make_optimizer(model.parameters(), cfg.training)
        self.replicate()
        # the variants (with_detections / with_param_metrics) are made on
        # their cadences, once each; on a card their graphs share one
        # memory pool (they never run at once)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self.train_step = make_train_step(model, cfg, self.optimizer,
                                          graph_pool=self._pool,
                                          group=self.mesh.group)
        self._steps = {(False, False): self.train_step}
        self._feed = PinnedFeed(self.device)
        self.ckpt = CheckpointManager(Path(trainer_cfg.ckpt_dir),
                                      monitor=trainer_cfg.monitor)
        self.artifacts = None
        if trainer_cfg.artifact_dir is not None:
            self.artifacts = ArtifactRegistry(trainer_cfg.artifact_dir)
            if self.mesh.is_main:
                # one code snapshot per run (reference save_code=True)
                self.artifacts.publish_code(
                    Path(__file__).resolve().parents[2],
                    name=f"{trainer_cfg.artifact_name}-code")
        self.logger = MetricsLogger(Path(trainer_cfg.ckpt_dir)
                                    / "metrics.jsonl")
        self._lstm_states = None
        self._host_step = 0
        self._train_evaluator = None

    def _get_step(self, use_det: bool, use_pm: bool):
        key = (use_det, use_pm)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.model, self.cfg, self.optimizer,
                with_detections=use_det, with_param_metrics=use_pm,
                graph_pool=self._pool, group=self.mesh.group)
        return self._steps[key]

    def replicate(self, optimizer: bool = True) -> None:
        """Broadcast the parameters and BatchNorm buffers (and the
        optimizer's moments) from rank 0: the replicas are then equal."""
        tensors = module_tensors(self.model)
        if optimizer:
            tensors += self.optimizer.mu + self.optimizer.nu
        replicate_tree(self.mesh, tensors)

    def _log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.mesh.is_main:
            self.logger.log(step, metrics)

    # -- checkpoint/resume ---------------------------------------------------

    def state_dict(self) -> Dict:
        """What a checkpoint holds: parameters and BatchNorm buffers, the
        optimizer's moments and count, the host step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self._host_step}

    def _load(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self._host_step = int(state["step"])

    def restore(self, step: Optional[int] = None) -> bool:
        """Load the checkpoint of ``step`` (the latest when None); False
        when there is none."""
        state = self.ckpt.restore(step, map_location=self.device)
        if state is None:
            return False
        self._load(state)
        self.replicate()
        return True

    def load_weights(self, variables: Dict) -> None:
        """Weights-only init from flax-layout numpy variables (``params``
        and ``batch_stats``; reference resume_only_weights,
        train.py:79-89), through the weight bridge."""
        self.model.load_state_dict(from_flax(variables), strict=True)
        self.replicate(optimizer=False)

    def _publish_checkpoint(self, step: int,
                            metric: Optional[float]) -> None:
        """Push the just-written step directory to the artifact registry:
        alias ``last`` always, ``best`` when it is the best checkpoint,
        then apply top-k retention (reference _scan_and_log_checkpoints)."""
        src = self.ckpt.step_dir(step)
        if not src.exists():
            return
        aliases = ["last"]
        if self.ckpt.best_step() == step:
            aliases.append("best")
        name = self.tcfg.artifact_name
        self.artifacts.publish(
            src, name, score=metric, step=step, aliases=aliases,
            metadata={"monitor": self.tcfg.monitor,
                      "keep_top_k": self.tcfg.artifact_top_k})
        self.artifacts.prune(name, self.tcfg.artifact_top_k)

    def restore_from_artifact(self, uri: str) -> bool:
        """Resume from a published artifact (reference get_checkpoint,
        wandb_logger.py:77-87): resolve and md5-verify the payload, copy
        it into this run's checkpoint tree, restore. A local step
        directory that is already there is checked against the manifest's
        md5s and copied again when it differs. Rank 0 copies; every rank
        then restores the copy."""
        if self.artifacts is None:
            raise ValueError("TrainerConfig.artifact_dir is not set")
        payload, manifest = self.artifacts.resolve(uri)
        step = int(manifest["step"] if manifest["step"] is not None
                   else payload.name)
        dst = self.ckpt.step_dir(step)
        if self.mesh.is_main:
            if dst.exists() and _file_manifest(dst) != manifest["files"]:
                shutil.rmtree(dst)
            if not dst.exists():
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copytree(payload, dst)
        if self.mesh.world > 1:
            dist.barrier(self.mesh.group)
        return self.restore(step)

    # -- train-time detection metrics ----------------------------------------

    def _consume_train_detections(self, batch: Batch, det_out,
                                  evaluate: bool, step: int) -> None:
        """Feed one training batch's detections into a train-mode
        Prophesee evaluator; on ``evaluate`` steps merge the processes'
        buffers, score them and log train/AP* (modules/detection.py:
        199-205). ``batch`` is this rank's lanes of the step's batch."""
        cfg = self.cfg
        if self._train_evaluator is None:
            self._train_evaluator = PropheseeEvaluator(
                cfg.dataset.name, cfg.dataset.downsample_by_factor_2)
        outputs = [o.cpu().numpy() for o in det_out]
        frames = list(iter_batch_detections(batch, *outputs))
        if frames:
            self._train_evaluator.add_labels([f[2] for f in frames])
            self._train_evaluator.add_predictions([f[3] for f in frames])
        if not evaluate:
            return
        merge_evaluator_buffers(self._train_evaluator)
        if self._train_evaluator.has_data():
            h, w = cfg.dataset.dataloading_hw
            m = self._train_evaluator.evaluate_buffer(img_height=h,
                                                      img_width=w)
            if m:
                self._log(step, {f"train/{k}": v for k, v in m.items()})
        self._train_evaluator.reset_buffer()
        if self.tcfg.train_viz_dir is not None and self.mesh.is_main:
            self._write_train_panels(batch, frames, step)

    def _write_train_panels(self, batch: Batch, frames, step: int) -> None:
        """Panels of the first ``train_viz_max_panels`` labelled frames of
        the evaluated step's batch (callbacks/detection.py:32-100)."""
        out_dir = Path(self.tcfg.train_viz_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, (b, t_step, gt, pred) in enumerate(
                frames[:self.tcfg.train_viz_max_panels]):
            _write_panel(out_dir / f"step_{step:07d}_{i}.png",
                         batch.ev_repr[b, t_step], gt, pred,
                         labelmap_of(self.cfg))

    # -- training loop -------------------------------------------------------

    def _local(self, batch: Batch) -> Batch:
        """This rank's lanes of ``batch`` (views)."""
        lanes = self.mesh.lanes(batch.batch_size)
        return replace(batch, **{
            f.name: getattr(batch, f.name)[lanes] for f in fields(batch)
            if isinstance(getattr(batch, f.name), np.ndarray)})

    def _to_device(self, batch: Batch):
        """The step's tensors of ``batch`` (this rank's lanes) through the
        pinned feed: the window laid out for the model, labels, label
        mask, frame validity, restarts, then the token mask (None without
        masking)."""
        bb = self.model.cfg.backbone
        if batch.token_mask is not None and not bb.enable_masking:
            raise ValueError("batch carries a token_mask but the model "
                             "has enable_masking=False")
        ev, stored = stored_layout(batch.ev_repr)
        arrays = [ev, batch.labels, batch.label_mask, batch.frame_valid,
                  batch.is_first_sample]
        if batch.token_mask is not None:
            arrays.append(batch.token_mask)
        out = self._feed(arrays)
        out[0] = window_input(out[0], stored, bb.in_res_hw, bb.stem_s2d)
        if batch.token_mask is None:
            out.append(self._token_mask(batch))
        return out

    def _token_mask(self, batch: Batch) -> Optional[torch.Tensor]:
        bb = self.model.cfg.backbone
        if not bb.enable_masking:
            return None
        # an all-False mask: masked and unmasked batches then run the same
        # path (stage 1's LN outside the kernels)
        ps = bb.stem_patch_size
        b_, t_, h_, w_ = batch.ev_repr.shape[:4]
        return torch.zeros((b_, t_, h_ // ps, w_ // ps), dtype=torch.bool,
                           device=self.device)

    def fit(self, batches: Iterable[Batch],
            eval_fn: Optional[Callable[[RVTDetector],
                                       Optional[Dict[str, float]]]] = None
            ) -> Dict[str, float]:
        """Run up to max_steps TBPTT windows. ``eval_fn(model)`` is called
        every val_every_n_steps and returns metrics (with the monitored
        key) or None. Returns the metrics of the last logged step."""
        if self.tcfg.prefetch_depth > 0:
            batches = PrefetchIterator(batches, self.tcfg.prefetch_depth)

        self._clock = [time.perf_counter(), 0]  # start, frames done
        last_metrics: Dict[str, float] = {}
        try:
            for batch in batches:
                if self._host_step >= self.tcfg.max_steps:
                    break
                logged = self._fit_one(batch, eval_fn)
                if logged is not None:
                    last_metrics = logged
        finally:
            if hasattr(batches, "close"):  # the prefetch thread
                batches.close()
        return last_metrics

    def _fit_one(self, batch: Batch, eval_fn) -> Optional[Dict[str, float]]:
        """One step of ``fit`` with its logging, checkpoint and validation;
        returns the metrics when this step logs them."""
        tc = self.tcfg
        K = self.cfg.dataset.max_labeled_frames
        # gather_labeled_frames drops labelled frames beyond K; in training
        # that silently reduces supervision
        n_lab = int(batch.frame_valid.sum(axis=1).max())
        if n_lab > K:
            raise ValueError(
                f"training window has {n_lab} labelled frames > "
                f"max_labeled_frames={K}; raise "
                "DatasetConfig.max_labeled_frames")
        local = self._local(batch)
        if self._lstm_states is None:
            self._lstm_states = zero_states(self.model.cfg.backbone,
                                            local.batch_size,
                                            device=self.device)
        arrays = self._to_device(local)
        step = self._host_step + 1
        use_det = evaluate = False
        if tc.detection_metrics_every_n_steps:
            r = step % tc.detection_metrics_every_n_steps
            n_acc = max(1, tc.detection_metrics_n_batches)
            evaluate = r == 0
            use_det = evaluate or r > (tc.detection_metrics_every_n_steps
                                       - n_acc)
        use_pm = bool(tc.gradflow_every_n_steps) and (
            step % tc.gradflow_every_n_steps == 0)
        out = self._get_step(use_det, use_pm)(self._lstm_states, *arrays)
        self._lstm_states, metrics = out[:2]
        if use_det:
            self._consume_train_detections(local, out[2], evaluate, step)
        self._clock[1] += batch.batch_size * batch.seq_len
        self._host_step = step

        logged = None
        if step % tc.log_every_n_steps == 0:
            logged = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - self._clock[0]
            logged["train/frames_per_s"] = self._clock[1] / max(dt, 1e-9)
            self._log(step, {k if k.startswith("train/") else f"train/{k}": v
                             for k, v in logged.items()})
        # rank 0 alone writes to the shared checkpoint tree and registry;
        # every rank computes the same validation metric (the evaluator
        # merge), so the retention decision agrees anyway
        if step % tc.ckpt_every_n_steps == 0 and self.mesh.is_main:
            self.ckpt.save(self.state_dict(), step)
            if self.artifacts is not None:
                self._publish_checkpoint(step, None)
        if (eval_fn is not None and tc.val_every_n_steps
                and step % tc.val_every_n_steps == 0):
            val_metrics = eval_fn(self.model)
            if val_metrics:
                self._log(step, {f"val/{k}": v
                                 for k, v in val_metrics.items()})
            if val_metrics and self.mesh.is_main:
                metric = val_metrics.get(tc.monitor)
                self.ckpt.save(self.state_dict(), step, metric=metric)
                if self.artifacts is not None:
                    self._publish_checkpoint(step, metric)
        return logged
