"""The port's SimOTA assignment and YOLOX loss (rvt_tpu_torch.ops.simota,
rvt_tpu_torch.training.losses) against the JAX package's on the same
predictions: padded GTs, an invalid frame, a GT with no anchor within its
centre radius (its candidate costs tie at 1e6 in f32, so the tie order
decides its match), and the loss gradient with respect to the
predictions."""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.config import preset
from rvt_tpu.ops.simota import simota_assign as j_assign
from rvt_tpu.training.losses import yolox_loss as j_loss
from rvt_tpu.training.step import head_grid as j_head_grid
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.ops.simota import simota_assign as t_assign
from rvt_tpu_torch.training.losses import yolox_loss as t_loss
from rvt_tpu_torch.training.step import head_grid as t_head_grid

RTOL = 2e-4  # f32 on both sides; sums and transcendental ulps differ
NC = 2


def _case(seed):
    cfg = preset("gen1", "tiny", resolution_hw=(64, 80))
    grid, strides = j_head_grid(cfg)
    A = grid.shape[0]
    rng = np.random.RandomState(seed)
    F, M = 4, 5
    centers = (grid + 0.5) * strides[:, None]
    xy = centers + rng.randn(A, 2) * strides[:, None] * 0.3
    wh = np.exp(rng.randn(F, A, 2) * 0.3) * strides[None, :, None] * 2
    preds = np.concatenate([np.broadcast_to(xy, (F, A, 2)), wh,
                            rng.randn(F, A, 1 + NC) * 2], -1)
    gt = np.zeros((F, M, 5), np.float32)
    mask = np.zeros((F, M), bool)
    gt[0, :3] = [(0, 20, 16, 18, 14), (1, 60, 40, 24, 20), (0, 70, 20, 8, 6)]
    gt[1, :2] = [(1, 30, 30, 40, 30), (0, 31, 29, 38, 28)]  # overlapping
    gt[2, :2] = [(0, 40, 32, 20, 16), (1, -300, 400, 10, 10)]  # no anchor
    gt[3, :1] = [(1, 50, 30, 20, 20)]  # frame 3 is invalid below
    mask[0, :3] = mask[1, :2] = mask[2, :2] = mask[3, :1] = True
    fv = np.array([True, True, True, False])
    return (preds.astype(np.float32), gt, mask, fv,
            grid.astype(np.float32), strides.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simota_assign_matches_jax(seed):
    preds, gt, mask, fv, grid, strides = _case(seed)
    gm = mask & fv[:, None]
    ref = jax.vmap(lambda b, o, c, gb, gc, m: j_assign(
        b, o, c, gb, gc, m, jnp.asarray(grid), jnp.asarray(strides), NC))(
        jnp.asarray(preds[..., :4]), jnp.asarray(preds[..., 4]),
        jnp.asarray(preds[..., 5:]), jnp.asarray(gt[..., 1:]),
        jnp.asarray(gt[..., 0].astype(np.int32)), jnp.asarray(gm))
    t = torch.from_numpy
    got = t_assign(t(preds[..., :4]), t(preds[..., 4]), t(preds[..., 5:]),
                   t(gt[..., 1:]), t(gt[..., 0].astype(np.int32)), t(gm),
                   t(grid), t(strides), NC)
    np.testing.assert_array_equal(got.fg_mask.numpy(), np.asarray(ref.fg_mask))
    np.testing.assert_array_equal(got.matched_gt.numpy(),
                                  np.asarray(ref.matched_gt))
    np.testing.assert_allclose(got.pred_ious.detach().numpy(),
                               np.asarray(ref.pred_ious), rtol=RTOL,
                               atol=1e-6)
    assert got.fg_mask[2].any()  # frame 2 still has positives
    # the GT far outside the image is matched only through 1e6 ties
    assert (got.matched_gt[2][got.fg_mask[2]] == 1).any() == bool(
        (np.asarray(ref.matched_gt)[2][np.asarray(ref.fg_mask)[2]] == 1).any())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yolox_loss_and_grad_match_jax(seed):
    preds, gt, mask, fv, grid, strides = _case(seed)

    def jl(p):
        out = j_loss(p, jnp.asarray(gt), jnp.asarray(mask), jnp.asarray(fv),
                     jnp.asarray(grid), jnp.asarray(strides), NC)
        return out["loss"], out

    (_, ref), jg = jax.value_and_grad(jl, has_aux=True)(jnp.asarray(preds))
    tp = torch.from_numpy(preds).requires_grad_(True)
    got = t_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask),
                 torch.from_numpy(fv), torch.from_numpy(grid),
                 torch.from_numpy(strides), NC)
    got["loss"].backward()
    for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg"):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=RTOL,
                                   err_msg=k)
    jg = np.asarray(jg)
    err = np.abs(tp.grad.numpy() - jg).max() / np.abs(jg).max()
    assert err < RTOL, err
    assert not tp.grad[3].any()  # the invalid frame contributes nothing


def test_head_grid_matches_jax():
    cfg = preset("gen1", "base")
    jg, js = j_head_grid(cfg)
    tg, ts = t_head_grid(t_preset("gen1", "base"))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(ts, js)
    assert tg.shape == (1680, 2)


@pytest.mark.parametrize("cap", [True, False])
def test_decode_caps_log_sizes_that_overflow(cap, monkeypatch):
    """A box log-size above ~85 overflows exp to inf, and the loss's
    backward multiplies the inf by the zero gradient of an IoU it does not
    move: NaN in every head parameter's gradient. The decode caps log-sizes
    at ``LOG_WH_MAX`` (a side of 5.5e34 strides), so the gradient stays
    finite; uncapped (``cap`` False) it does not."""
    import rvt_tpu_torch.models.yolox as yolox

    if not cap:
        monkeypatch.setattr(yolox, "LOG_WH_MAX", float("inf"))
    cfg = t_preset("gen1", "tiny", resolution_hw=(64, 80))
    torch.manual_seed(0)
    head = yolox.YoloXHead(cfg.model.head, (32, 64, 128))
    with torch.no_grad():
        head.reg_preds[1].bias[2] = 100.0  # every stride-16 anchor's width
    feats = [torch.randn(4, c, 64 // s, 96 // s)  # 64 x 80 padded
             for c, s in ((32, 8), (64, 16), (128, 32))]
    preds = head(feats, torch.float32)
    assert torch.isfinite(preds).all() == cap
    _, gt, mask, fv, grid, strides = _case(0)
    loss = t_loss(preds, torch.from_numpy(gt), torch.from_numpy(mask),
                  torch.from_numpy(fv), torch.from_numpy(grid),
                  torch.from_numpy(strides), NC)["loss"]
    assert torch.isfinite(loss)
    loss.backward()
    finite = all(torch.isfinite(p.grad).all() for p in head.parameters())
    assert finite == cap
