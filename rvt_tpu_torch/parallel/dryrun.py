"""The multi-process dry run and the rank worker that runs it: the
port's twin of ``dryrun_multichip`` (``__graft_entry__.py:56``).

``dryrun_multichip(n)`` spawns ``n`` rank processes that each build a
tiny gen1 detector (one lane a rank, confidence threshold 0) and run, on
both legs (the module path in f32 and the kernels route in bf16), one
data-parallel train step and then an eval step on their lanes. It
asserts a finite loss, more than zero detections over the ranks and
bit-identical replicas after the step. On the CPU (``device="cpu"``) the
ranks run the kernels' plain versions over gloo.

The ranks are processes of this module (``python -m
rvt_tpu_torch.parallel.dryrun SPEC RANK WORLD STORE``), so that no child
imports JAX: ``spawn`` writes a spec of scenarios, each a
``"module:function"`` called as ``function(mesh, device, **kwargs)`` in
every rank, starts the ranks over a ``file://`` store, joins them with a
timeout and returns each rank's results. The dry run's legs are
``dryrun_leg`` here; other callers name functions of their own modules
(which must not import JAX either).
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
import uuid
from dataclasses import replace
from pathlib import Path
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from rvt_tpu_torch import resolve_device
from rvt_tpu_torch.parallel.mesh import (DataParallel, init_process_group,
                                         make_mesh, module_tensors,
                                         replicate_tree, same_on_all_ranks)

REPO = Path(__file__).resolve().parents[2]
LEGS = ("modules", "kernels")
LEG = "rvt_tpu_torch.parallel.dryrun:dryrun_leg"  # the legs' scenario


def dryrun_config(leg: str):
    """The dry run's tiny gen1 config for ``leg``: ``"modules"`` (f32,
    the module path) or ``"kernels"`` (bf16 and the kernels)."""
    from rvt_tpu_torch.config import preset

    cfg = preset("gen1", "tiny", resolution_hw=(64, 64), sequence_length=2,
                 max_labels_per_frame=4, max_labeled_frames=2)
    # confidence threshold 0: random weights score every anchor near the
    # head's prior, so NMS has candidates and the eval check is not vacuous
    model = replace(cfg.model, postprocess=replace(
        cfg.model.postprocess, confidence_threshold=0.0))
    if leg == "kernels":
        model = replace(model, compute_dtype="bfloat16",
                        backbone=replace(model.backbone, fused_kernels=True))
    return replace(cfg, model=model)


def dryrun_batch(cfg, lanes: int):
    """The dry run's global batch: uint8 events in [0, 4) from numpy seed
    0, one box on the last frame of every lane, every lane restarting."""
    T = cfg.dataset.sequence_length
    H, W = cfg.dataset.dataloading_hw
    M = cfg.dataset.max_labels_per_frame
    rng = np.random.RandomState(0)
    ev = rng.randint(0, 4, size=(lanes, T, H, W, 20)).astype(np.uint8)
    labels = np.zeros((lanes, T, M, 7), np.float32)
    label_mask = np.zeros((lanes, T, M), bool)
    labels[:, -1, 0] = (0, 20.0, 20.0, 16.0, 16.0, 0.0, 1.0)
    label_mask[:, -1, 0] = True
    return ev, labels, label_mask, label_mask.any(-1), np.ones(lanes, bool)


def dryrun_leg(mesh: DataParallel, device, leg: str):
    """One leg of the dry run on this rank: a data-parallel train step on
    its lane of the global batch, then an eval step; returns the loss,
    the detections over every rank, their checksum and whether the
    replicas are bit for bit equal after the step."""
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_eval_step, make_train_step

    cfg = dryrun_config(leg)
    model = init_detector(cfg.model, seed=0, device=device)
    replicate_tree(mesh, module_tensors(model))
    opt = make_optimizer(model.parameters(), cfg.training)
    lanes = mesh.lanes(mesh.world)
    arrays = [torch.from_numpy(a[lanes]).to(device)
              for a in dryrun_batch(cfg, mesh.world)]
    bb = cfg.model.backbone
    n = lanes.stop - lanes.start
    step = make_train_step(model, cfg, opt, group=mesh.group)
    _, metrics = step(zero_states(bb, n, device=device), *arrays)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dryrun {leg}: loss {loss}")
    replicas = same_on_all_ranks(mesh, module_tensors(model))
    out = make_eval_step(model, cfg)(zero_states(bb, n, device=device),
                                     arrays[0], arrays[3], arrays[4])
    sums = torch.stack([
        out.det_valid.sum().double(),
        torch.where(out.det_valid[..., None], out.dets.double(), 0.0).sum()])
    if mesh.world > 1:
        host = sums.cpu() if mesh.backend == "gloo" else sums
        dist.all_reduce(host, group=mesh.group)
        sums = host
    n_det, checksum = int(sums[0]), float(sums[1])
    if not np.isfinite(checksum) or n_det <= 0 or not replicas:
        raise RuntimeError(f"dryrun {leg}: {n_det} detections, checksum "
                           f"{checksum}, replicas equal: {replicas}")
    return dict(loss=loss, dets=n_det, checksum=checksum, replicas=replicas)


def spawn(scenarios, n: int, workdir, *, device="cuda",
          timeout: float = 600.0) -> List[list]:
    """Run ``scenarios`` (a list of ("module:function", kwargs); a
    ``per_rank`` entry of kwargs maps each rank to its own extra kwargs)
    in ``n`` rank processes of this module, in order, on ``device``
    (each rank on its card where there are enough, else sharing one over
    gloo; without a card ``device="cuda"`` raises here), over a fresh
    ``file://`` store in ``workdir``. Joins every rank within
    ``timeout`` seconds; a rank that fails or hangs (all are then killed)
    raises with the end of its log. Returns each rank's list of results."""
    device = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex[:8]
    spec = workdir / f"spec-{tag}.pt"
    torch.save(dict(scenarios=list(scenarios), device=device.type), spec)
    store = f"file://{workdir.resolve()}/store-{tag}"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [workdir / f"rank{r}-{tag}.log" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "rvt_tpu_torch.parallel.dryrun",
                     str(spec), str(r), str(n), store],
                    stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=str(REPO)))
        deadline = time.monotonic() + timeout
        while True:  # a rank that fails ends the spawn at once
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} of {n} failed (exit {codes[bad[0]]}):\n"
                    + _tail(logs[bad[0]]))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                r = codes.index(None)
                raise RuntimeError(
                    f"rank {r} of {n} did not finish within {timeout} s:\n"
                    + _tail(logs[r]))
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(workdir / f"result-{tag}-{r}.pt", weights_only=False)
            for r in range(n)]


def _tail(path: Path, n: int = 60) -> str:
    return "\n".join(path.read_text(errors="replace").splitlines()[-n:])


def dryrun_multichip(n_devices: int, device="cuda", workdir=None,
                     timeout: float = 600.0) -> str:
    """Spawn ``n_devices`` ranks, one lane each, and run both legs of the
    dry run (``dryrun_leg``) on ``device``; raises if a rank fails.
    Returns and prints the summary line."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="rvt_dryrun_") as tmp:
        results = spawn([(LEG, dict(leg=leg))
                         for leg in LEGS], n_devices, workdir or tmp,
                        device=device, timeout=timeout)
    summary = " | ".join(
        f"{leg}: loss={r['loss']:.4f} dets={r['dets']} "
        f"checksum={r['checksum']:.4f}"
        for leg, r in zip(LEGS, results[0]))
    line = f"dryrun_multichip({n_devices}): {summary} OK"
    print(line)
    return line


def main(argv=None) -> None:
    """A rank: ``SPEC RANK WORLD STORE``. Joins the group, runs the spec's
    scenarios in order and saves their results beside the spec."""
    spec_path, rank, world, store = (argv or sys.argv[1:])[:4]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    device = init_process_group(spec["device"], init_method=store, rank=rank,
                                world_size=world)
    try:
        mesh = make_mesh()
        results = []
        for name, kwargs in spec["scenarios"]:
            module, function = name.split(":")
            fn = getattr(importlib.import_module(module), function)
            kwargs = dict(kwargs)
            kwargs.update(kwargs.pop("per_rank", {}).get(rank, {}))
            results.append(fn(mesh, device, **kwargs))
        tag = Path(spec_path).stem.split("-", 1)[1]
        out = Path(spec_path).parent / f"result-{tag}-{rank}.pt"
        torch.save(results, out.with_suffix(".tmp"))
        os.replace(out.with_suffix(".tmp"), out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
