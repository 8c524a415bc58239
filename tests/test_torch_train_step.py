"""The port's train step (rvt_tpu_torch.training.step.make_train_step, the
kernels' plain versions on the CPU) against the JAX package's
``make_train_step`` with the fused train kernels (interpret mode, a mesh
of one device), over two carried TBPTT windows of gen1 tiny at (64, 80),
T = 3, B = 2, K = 2, M = 4. Both start from the same random weights (the
port's, carried to flax by the JAX package's converter) and fresh
optimizers.

SimOTA picks, with random weights, about one anchor per GT by a margin
smaller than the bf16 noise of two frameworks' convolutions (the head
alone, fed identical features, differs by ~4% of its largest output), so
the choice flips between the two sides. Here both take the same
geometric assignment (each GT's nearest anchor centre; its IoU, a function
of the predictions, still carries the gradient); SimOTA itself is held
against JAX on identical predictions in ``test_torch_losses.py``, and on
the card the kernel step is held against the plain step with SimOTA.
"""
import copy
from dataclasses import replace

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rvt_tpu.training.losses as jlosses
import rvt_tpu_torch.training.losses as tlosses
from rvt_tpu.config import preset
from rvt_tpu.convert.torch_ckpt import convert_state_dict
from rvt_tpu.models import RVTDetector
from rvt_tpu.models.backbone import zero_states
from rvt_tpu.ops.boxes import pairwise_iou_cxcywh as j_iou
from rvt_tpu.ops.simota import SimOTAAssignment as JAssign
from rvt_tpu.parallel.mesh import make_mesh
from rvt_tpu.training import step as jstep
from rvt_tpu.training.optimizer import make_optimizer as j_make_optimizer
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.models.detector import init_detector as t_init_detector
from rvt_tpu_torch.ops.boxes import pairwise_iou_cxcywh as t_iou
from rvt_tpu_torch.ops.simota import SimOTAAssignment as TAssign
from rvt_tpu_torch.training import step as tstep
from rvt_tpu_torch.training.optimizer import make_optimizer

T, B, K, M = 3, 2, 2, 4

# Tolerances. Both sides run the same arithmetic and bf16 rounding points
# (the JAX train kernels in interpret mode, the port's plain versions);
# f32 sums run in other orders, which moves a bf16 rounding by one ulp now
# and then, and the FPN/head's bf16 convolutions are XLA's and oneDNN's.
# The backbone features then differ by 2-5 bf16 ulps (test_torch_slice.py
# holds the eval step's states at 4e-2 / 8e-2), and this step amplifies
# that: batch-statistics BatchNorm over 4 frames down to 2x3 maps. Moving
# one stem weight by 1e-3 of itself moves the step's gradient by ~11%
# (relative L2); the test measures that sensitivity and holds the
# port-vs-JAX gradient error within twice it (13% seen).
LOSS_RTOL = 2e-2        # loss parts (0.7% seen)
NORM_RTOL = 1e-1        # grad_norm (2% and 7% seen; 3.6% under 1e-3 noise)
LEAF_L2 = 0.5           # each leaf's |g - ref|_2 / |ref|_2 (0.29 seen)
H_ATOL, C_ATOL = 4e-2, 8e-2   # final (h, c) (0.016 / 0.031 seen)
BN_TOL = 2e-2           # running mean / var, of max |ref| (0.010 seen)


def _cfg(preset_fn, masked=False, conf=None):
    """gen1 tiny with the train kernels; with ``masked`` the stage-1 mask
    token, with ``conf`` that confidence threshold for the detections."""
    cfg = preset_fn("gen1", "tiny", resolution_hw=(64, 80),
                    sequence_length=T, max_labels_per_frame=M,
                    max_labeled_frames=K)
    pp = cfg.model.postprocess
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         enable_masking=masked),
        postprocess=replace(pp, confidence_threshold=(
            pp.confidence_threshold if conf is None else conf))))


def _batch(rng):
    ev = rng.randint(0, 8, (B, T, 64, 80, 20)).astype(np.uint8)
    labels = np.zeros((B, T, M, 7), np.float32)
    mask = np.zeros((B, T, M), bool)
    # lane 0: labels at t = 1, 2 (3 and 2 boxes, padded slots after);
    # lane 1: one labelled frame only, so its second gathered frame is
    # padding (frame_valid False)
    labels[0, 1, :3] = [(0, 10, 8, 20, 16, 0, 1), (0, 40, 30, 12, 10, 1, 1),
                        (0, 50, 5, 25, 20, 0, 1)]
    labels[0, 2, :2] = [(0, 12, 10, 20, 16, 0, 1), (0, 38, 28, 14, 12, 1, 1)]
    labels[1, 2, :1] = [(0, 20, 20, 30, 24, 1, 1)]
    mask[0, 1, :3] = mask[0, 2, :2] = mask[1, 2, :1] = True
    return ev, labels, mask, mask.any(-1)


def _j_geometric(pred_boxes, obj_logit, cls_logit, gt_boxes, gt_classes,
                 gt_mask, grid_xy, anchor_strides, num_classes):
    """JAX side (one frame): each valid GT takes its nearest anchor centre;
    an anchor two GTs pick goes to the first."""
    A = pred_boxes.shape[0]
    centers = (grid_xy + 0.5) * anchor_strides[:, None]
    d = jnp.sum((gt_boxes[:, None, :2] - centers[None]) ** 2, -1)
    pick = jnp.arange(A)[None] == jnp.argmin(d, axis=1)[:, None]
    pick = pick & gt_mask[:, None]
    matching = pick & (jnp.cumsum(pick, axis=0) == 1)
    ious = j_iou(gt_boxes, pred_boxes)
    fg = matching.any(0)
    return JAssign(fg, jnp.argmax(matching, 0).astype(jnp.int32),
                   jnp.sum(matching * ious, 0), jnp.sum(fg))


def _t_geometric(pred_boxes, obj_logit, cls_logit, gt_boxes, gt_classes,
                 gt_mask, grid_xy, anchor_strides, num_classes):
    """The same assignment on the port's side, batched over frames."""
    A = pred_boxes.shape[1]
    centers = (grid_xy + 0.5) * anchor_strides[:, None]
    d = ((gt_boxes[:, :, None, :2] - centers[None, None]) ** 2).sum(-1)
    pick = torch.arange(A)[None, None] == d.argmin(2)[..., None]
    pick = pick & gt_mask[..., None]
    matching = pick & (pick.cumsum(1) == 1)
    ious = t_iou(gt_boxes, pred_boxes)
    fg = matching.any(1)
    return TAssign(fg, matching.to(torch.int32).argmax(1),
                   (matching * ious).sum(1), fg.float().sum(-1))


def train_runs(masked=False, conf=None):
    """Two carried windows on both sides (``_run``) with the geometric
    assignment. ``masked``: a seeded stage-1 token mask (about 20 % of the
    tokens, at the storage resolution's token grid) on every window.
    ``conf``: both steps also return their detections and parameter
    metrics, at that confidence threshold."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlosses, "simota_assign", _j_geometric)
    mp.setattr(tlosses, "simota_assign", _t_geometric)
    try:
        return _run(masked, conf)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs():
    return train_runs()


def _run(masked, conf):
    variants = conf is not None
    cfg, tcfg = _cfg(preset, masked, conf), _cfg(t_preset, masked, conf)
    tmodel = t_init_detector(tcfg.model, seed=0, device="cpu")
    # off the identity-ish init (LayerScale 1e-5, unit BatchNorm) so the
    # attention blocks shape the features and their gradients
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, p in tmodel.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(rng.normal(0, 0.1, p.shape)))
            elif name.endswith(".bias"):
                p.add_(torch.from_numpy(0.05 * rng.randn(*p.shape)))
        for name, b in tmodel.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.1 * rng.randn(*b.shape)))
    variables = convert_state_dict({k: v.numpy()
                                    for k, v in tmodel.state_dict().items()})
    model = RVTDetector(cfg=cfg.model)
    opt = j_make_optimizer(cfg.training)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jstep.TrainState(params=params, batch_stats=jax.tree.map(
        jnp.asarray, variables["batch_stats"]), opt_state=opt.init(params),
        step=jnp.zeros((), jnp.int32))
    # the port's own sensitivity: the first window's gradient with one
    # weight moved by 1e-3 of itself
    moved = copy.deepcopy(tmodel)
    with torch.no_grad():
        w = moved.backbone.stages[0].downsample_cf2cl.conv.weight
        w.mul_(1 + 1e-3 * torch.from_numpy(
            np.random.RandomState(9).randn(*w.shape)).float())
    topt = make_optimizer(tmodel.parameters(), tcfg.training)
    kw = dict(with_detections=variants, with_param_metrics=variants)
    jtrain = jstep.make_train_step(model, cfg, opt, donate=False,
                                   mesh=make_mesh(1), **kw)
    ttrain = tstep.make_train_step(tmodel, tcfg, topt, **kw)
    # the port's head outputs, for its detections
    tpreds, forward_detect = [], tmodel.forward_detect
    tmodel.forward_detect = lambda f: (tpreds.append(forward_detect(f))
                                       or tpreds[-1])

    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(2)]
    firsts = [np.array([True, False]), np.array([False, False])]
    ps = cfg.model.backbone.stem_patch_size
    tms = [np.random.RandomState(11 + i).rand(B, T, 64 // ps, 80 // ps) < 0.2
           if masked else None for i in range(2)]
    jst = zero_states(cfg.model.backbone, B)
    tst = tuple((torch.zeros(h.shape), torch.zeros(c.shape)) for h, c in jst)
    jout, tout, grads, dets = [], [], None, []
    for (ev, labels, mask, fv), first, tmask in zip(batches, firsts, tms):
        jres = jtrain(state, jst, jnp.asarray(ev), jnp.asarray(labels),
                      jnp.asarray(mask), jnp.asarray(fv), jnp.asarray(first),
                      None if tmask is None else jnp.asarray(tmask))
        state, jst, jm = jres[:3]
        jout.append(jax.tree.map(np.asarray, (jst, jm)))
        tres = ttrain(tst, torch.from_numpy(ev), torch.from_numpy(labels),
                      torch.from_numpy(mask), torch.from_numpy(fv),
                      torch.from_numpy(first),
                      None if tmask is None else torch.from_numpy(tmask))
        tst, tm = tres[:2]
        tout.append((tst, {k: float(v) for k, v in tm.items()}))
        if variants:
            dets.append((jax.tree.map(np.asarray, jres[3]), tres[2],
                         tpreds[-1].detach()))
        if grads is None:
            # JAX's first-window gradient, read from its Adam moment: after
            # one step mu = (1 - b1) * clip(g), and clip scales by
            # 1 / ||g|| when ||g|| >= 1 (grad_norm is the raw norm)
            gn = float(jm["grad_norm"])
            mu = np.asarray(state.opt_state[1][0].mu, np.float64)
            g = mu / (1.0 - 0.9) * (gn if gn >= 1.0 else 1.0)
            unravel = jax.flatten_util.ravel_pytree(params)[1]
            grads = (from_flax({"params": jax.tree.map(
                np.asarray, unravel(jnp.asarray(g, jnp.float32)))}),
                {n: (p.grad.clone() if p.grad is not None
                     else torch.zeros_like(p))
                 for n, p in tmodel.named_parameters()})
    tstep.make_train_step(moved, tcfg, make_optimizer(
        moved.parameters(), tcfg.training))(
        tuple((torch.zeros(h.shape), torch.zeros(c.shape)) for h, c in jst),
        *(torch.from_numpy(a) for a in batches[0]),
        torch.from_numpy(firsts[0]),
        None if tms[0] is None else torch.from_numpy(tms[0]))
    moved_grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in moved.named_parameters()}
    return dict(jout=jout, tout=tout, state=state, tmodel=tmodel,
                grads=grads + (moved_grads,), dets=dets, cfg=cfg,
                lrs=[topt.schedule(0), topt.schedule(1)])


def check_losses(runs, cls_of_loss=False):
    """Each loss part within LOSS_RTOL of itself; with ``cls_of_loss`` the
    class loss within LOSS_RTOL of the whole loss instead."""
    for (_, jm), (_, tm) in zip(runs["jout"], runs["tout"]):
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg"):
            if cls_of_loss and k == "cls_loss":
                assert abs(tm[k] - float(jm[k])) <= LOSS_RTOL * abs(
                    float(jm["loss"])), k
                continue
            np.testing.assert_allclose(tm[k], float(jm[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(tm["grad_norm"], float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
        assert tm["num_fg"] > 0 and tm["loss"] > 0


def check_final_states(runs):
    for (jst, _), (tst, _) in zip(runs["jout"], runs["tout"]):
        for (hr, cr), (hg, cg) in zip(jst, tst):
            assert hg.dtype == torch.float32 and not hg.requires_grad
            np.testing.assert_allclose(hg.numpy(), hr, atol=H_ATOL)
            np.testing.assert_allclose(cg.numpy(), cr, atol=C_ATOL)


def _l2(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def check_grads(runs):
    jg, tg, moved = runs["grads"]
    assert set(jg) == set(tg)
    for name, ref in jg.items():
        assert _l2(tg[name], ref) < LEAF_L2, name
    flat = {k: torch.cat([g[n].flatten() for n in sorted(jg)])
            for k, g in (("jax", jg), ("port", tg), ("moved", moved))}
    sensitivity = _l2(flat["moved"], flat["port"])
    assert 1e-3 < sensitivity < 0.5
    assert _l2(flat["port"], flat["jax"]) <= 2 * sensitivity


def check_bn_buffers_and_params(runs):
    ref = from_flax(jax.tree.map(np.asarray, {
        "params": runs["state"].params,
        "batch_stats": runs["state"].batch_stats}))
    got = runs["tmodel"].state_dict()
    # An Adam step moves each element by at most about lr; where a gradient
    # element near zero has opposite signs on the two sides, two steps move
    # them apart by up to 2 (lr0 + lr1). 99% of the elements stay within
    # 2.5 lr (99.5% seen), all within 2 (lr0 + lr1).
    lr0, lr1 = runs["lrs"]
    n_bn, d = 0, []
    for name, r in ref.items():
        g, r = got[name].numpy(), r.numpy()
        if name.endswith(("running_mean", "running_var")):
            assert np.abs(g - r).max() <= BN_TOL * np.abs(r).max(), name
            n_bn += 1
        elif not name.endswith("num_batches_tracked"):
            d.append(np.abs(g - r).ravel())
    d = np.concatenate(d)
    assert n_bn > 0
    assert d.max() <= 2 * (lr0 + lr1) * 1.001
    assert (d <= 2.5 * max(lr0, lr1)).mean() >= 0.99


def test_train_step_losses_match_jax(runs):
    check_losses(runs)


def test_train_step_final_states_match_jax(runs):
    check_final_states(runs)


def test_train_step_grads_match_jax(runs):
    check_grads(runs)


def test_train_step_bn_buffers_and_params_match_jax(runs):
    check_bn_buffers_and_params(runs)
