"""Rank scenarios of ``tests/test_torch_parallel.py``: functions
``fn(mesh, device, **kwargs)`` that ``rvt_tpu_torch.parallel.dryrun``'s
rank worker runs in each spawned process (named
``"tests.torch_dp_scenarios:<fn>"``). The ranks import this module, so it
imports nothing of JAX or of the JAX package."""
from __future__ import annotations

from pathlib import Path

import torch

from rvt_tpu_torch.parallel.mesh import (DataParallel, module_tensors,
                                         replicate_tree, same_on_all_ranks)

MODULE = "tests.torch_dp_scenarios"


def _model(cfg, state, device, mesh: DataParallel):
    """The detector of ``cfg`` with ``state``, broadcast from rank 0."""
    from rvt_tpu_torch.models.detector import init_detector

    model = init_detector(cfg.model, seed=0, device=device)
    model.load_state_dict(state, strict=True)
    replicate_tree(mesh, module_tensors(model))
    return model


def train_steps(mesh: DataParallel, device, cfg, state, batches):
    """Data-parallel train steps from the model ``state`` on this rank's
    lanes of each global batch (a tuple of arrays), the LSTM states
    carried. Returns each step's metrics and whether the replicas were
    bit for bit equal after it, and this rank's final LSTM states; rank 0
    also the first step's (global) gradients and the final state dict."""
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    model = _model(cfg, state, device, mesh)
    opt = make_optimizer(model.parameters(), cfg.training)
    step = make_train_step(model, cfg, opt, group=mesh.group)
    res = dict(metrics=[], replicas=[])
    states = None
    for arrays in batches:
        lanes = mesh.lanes(arrays[0].shape[0])
        if states is None:
            states = zero_states(cfg.model.backbone,
                                 lanes.stop - lanes.start, device=device)
        states, metrics = step(states, *(torch.from_numpy(a[lanes])
                                         for a in arrays))
        res["metrics"].append({k: float(v) for k, v in metrics.items()})
        res["replicas"].append(same_on_all_ranks(mesh,
                                                 module_tensors(model)))
        if "grads" not in res and mesh.is_main:
            # a copy: the gradients are views of the optimizer's flat
            # buffer, which the next step overwrites
            res["grads"] = {n: p.grad.detach().to("cpu", copy=True)
                            for n, p in model.named_parameters()}
    res["states"] = [tuple(x.cpu() for x in hc) for hc in states]
    if mesh.is_main:
        res["state"] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}
    return res


def eval_merge(mesh: DataParallel, device, labels, preds, marker_dir):
    """This rank's labelled frames (``labels``, ``preds``: lists of
    BBOX_DTYPE arrays) in a gen1 Prophesee evaluator, merged over the
    ranks and scored at 64 x 80; rank 0 alone writes
    ``marker_dir/ckpt_rank<r>`` (the gate of shared side effects).
    Returns the metrics and the merged buffer's bytes."""
    from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
    from rvt_tpu_torch.parallel.multihost import (is_main_process,
                                                  merge_evaluator_buffers)

    ev = PropheseeEvaluator("gen1")
    if labels:
        ev.add_labels(list(labels))
        ev.add_predictions(list(preds))
    merge_evaluator_buffers(ev)
    metrics = ev.evaluate_buffer(64, 80)
    if is_main_process():
        (Path(marker_dir) / f"ckpt_rank{mesh.rank}").write_text("ckpt")
    return dict(metrics=metrics, buffer=ev.state_bytes())


def allgather(mesh: DataParallel, device, payloads):
    """``allgather_bytes`` of this rank's entry of ``payloads``."""
    from rvt_tpu_torch.parallel.multihost import allgather_bytes

    return allgather_bytes(payloads[mesh.rank])


def trainer_fit(mesh: DataParallel, device, cfg, state, batches,
                trainer_kw):
    """``Trainer.fit`` over the global ``batches`` with ``TrainerConfig(
    **trainer_kw)``, data-parallel over the ranks. Returns the last
    logged metrics and whether the replicas (with the optimizer's
    moments) are equal after."""
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    model = init_detector(cfg.model, seed=0, device=device)
    model.load_state_dict(state, strict=True)
    trainer = Trainer(cfg, TrainerConfig(**trainer_kw), model=model,
                      device=device)
    last = trainer.fit(iter(batches))
    return dict(last=last, replicas=same_on_all_ranks(
        mesh, module_tensors(trainer.model) + trainer.optimizer.mu
        + trainer.optimizer.nu))


def train_cli(mesh: DataParallel, device, argv, preset_kw):
    """``cli.train.main(argv)`` (with ``--multihost``: the group this
    rank joined) at ``preset(..., **preset_kw)``, the tests' small
    geometry; returns the validations' metrics as ``eval_fn`` returned
    them on this rank."""
    from rvt_tpu_torch import config
    from rvt_tpu_torch.cli import train as cli

    seen = []
    real_preset, real_make = config.preset, cli.make_eval_fn

    def make_eval_fn(*a, **k):
        fn = real_make(*a, **k)

        def eval_fn(model):
            seen.append(fn(model))
            return seen[-1]
        return eval_fn

    config.preset = lambda d, s, **o: real_preset(d, s,
                                                  **dict(preset_kw, **o))
    cli.make_eval_fn = make_eval_fn
    try:
        cli.main(list(argv))
    finally:
        config.preset, cli.make_eval_fn = real_preset, real_make
    return dict(val=seen)


def scenario(name: str) -> str:
    """The worker's name of this module's function ``name``."""
    return f"{MODULE}:{name}"

