"""The port's streaming eval step (rvt_tpu_torch, plain PyTorch versions on
the CPU) against the JAX package's serving step at a tiny geometry, with
the JAX weights carried over by the weight bridge; and the port's NMS
postprocess against JAX's on the same prediction arrays."""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.config import preset
from rvt_tpu.models import RVTDetector, init_detector
from rvt_tpu.models.detector import scan_backbone
from rvt_tpu.ops.boxes import postprocess as j_postprocess
from rvt_tpu.parallel.mesh import make_mesh
from rvt_tpu.training import step as jstep
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.models.detector import init_detector as t_init_detector
from rvt_tpu_torch.ops.boxes import postprocess as t_postprocess
from rvt_tpu_torch.ops.s2d import host_space_to_depth
from rvt_tpu_torch.training.step import make_eval_step

T, B = 3, 2


def _serving_cfg(preset_fn):
    cfg = preset_fn("gen1", "tiny", resolution_hw=(64, 80),
                    sequence_length=T, max_labeled_frames=2)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         stem_s2d=True)))


@pytest.fixture(scope="module")
def slice_run():
    cfg, tcfg = _serving_cfg(preset), _serving_cfg(t_preset)
    model, variables = init_detector(cfg.model, jax.random.PRNGKey(0),
                                     batch_size=B)
    # perturb off the identity-ish init (LayerScale 1e-5, unit BN) so the
    # attention blocks and the BatchNorm statistics shape the outputs
    variables = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(
            np.random.RandomState(3).randn(*a.shape), a.dtype), variables)
    H, W = cfg.model.backbone.in_res_hw
    rng = np.random.RandomState(0)
    ev = host_space_to_depth(
        rng.randint(0, 8, (B, T, 60, 76, 20)).astype(np.uint8), (H, W))
    frame_valid = np.array([[False, True, True], [True, False, False]])
    is_first = np.array([True, False])
    states = [tuple((rng.randn(B, H // s, W // s, d) * 0.1).astype(np.float32)
                    for _ in range(2))
              for s, d in zip(cfg.model.backbone.strides,
                              cfg.model.backbone.stage_dims)]
    K = cfg.dataset.max_labeled_frames

    @jax.jit
    def jax_step(variables, states, ev, frame_valid, is_first):
        """make_eval_step up to the head output (the pieces it runs)."""
        states = jstep.reset_states(states, is_first)
        ev_seq = jnp.swapaxes(jstep.pad_ev_repr(
            ev, cfg.model.backbone.in_res_hw, None, True), 0, 1)
        # mesh of one device: the fused kernels, not the XLA fallback
        feats, final = scan_backbone(model, variables, ev_seq, states,
                                     deterministic=True, remat=False,
                                     mesh=make_mesh(1))
        gathered, frame_idx, gval = jstep.gather_labeled_frames(
            feats, frame_valid, K)
        preds = model.apply(variables, gathered, train=False,
                            method=RVTDetector.forward_detect)
        return final, preds, frame_idx, gval

    ref = jax_step(variables, tuple((jnp.asarray(h), jnp.asarray(c))
                                    for h, c in states),
                   jnp.asarray(ev), jnp.asarray(frame_valid),
                   jnp.asarray(is_first))
    tmodel = t_init_detector(tcfg.model, device="cpu")
    tmodel.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    got = make_eval_step(tmodel, tcfg)(
        tuple((torch.from_numpy(h), torch.from_numpy(c)) for h, c in states),
        torch.from_numpy(ev), torch.from_numpy(frame_valid),
        torch.from_numpy(is_first))
    return cfg, ref, got


def test_slice_final_states_match_jax(slice_run):
    _, (final, _, _, _), got = slice_run
    for (hr, cr), (hg, cg) in zip(final, got.states):
        np.testing.assert_allclose(hg.numpy(), np.asarray(hr), atol=4e-2)
        np.testing.assert_allclose(cg.numpy(), np.asarray(cr), atol=8e-2)


def test_slice_head_outputs_match_jax(slice_run):
    _, (_, preds, _, _), got = slice_run
    ref = np.asarray(preds, np.float32)
    out = got.preds.numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    scale = max(np.abs(ref).mean(), 1.0)
    assert np.abs(out - ref).max() < 0.05 * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).mean() < 5e-3 * scale


def test_slice_gather_matches_jax(slice_run):
    cfg, (_, _, frame_idx, gval), got = slice_run
    np.testing.assert_array_equal(got.frame_idx.numpy(),
                                  np.asarray(frame_idx))
    np.testing.assert_array_equal(got.gval.numpy(), np.asarray(gval))
    K = cfg.dataset.max_labeled_frames
    assert got.dets.shape == (B, K, cfg.model.postprocess.max_detections, 7)
    assert torch.isfinite(got.dets).all()
    assert not got.det_valid[~got.gval].any()


def _postprocess_both(pred: np.ndarray, num_classes, conf, topk):
    dj, vj = j_postprocess(jnp.asarray(pred), num_classes, conf, 0.45, topk,
                           300)
    dt, vt = t_postprocess(torch.from_numpy(pred), num_classes, conf, 0.45,
                           topk, 300)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5,
                               rtol=1e-5)
    return vt


@pytest.mark.parametrize("topk", [16, 0], ids=["pre_nms_topk", "all"])
def test_postprocess_on_slice_preds(slice_run, topk):
    """Both implementations on the JAX head output after sigmoid, with a
    threshold at the median score so that half the anchors enter NMS."""
    cfg, (_, preds, _, _), _ = slice_run
    preds = np.asarray(preds, np.float32)
    infer = np.concatenate([preds[..., :4],
                            1 / (1 + np.exp(-preds[..., 4:]))], -1)
    nc = cfg.model.head.num_classes
    conf = float(np.median(infer[..., 4] * infer[..., 5:5 + nc].max(-1)))
    valid = _postprocess_both(infer, nc, conf, topk)
    assert valid.any()


@pytest.mark.parametrize("n_hot", [300, 700], ids=["fast512", "overflow"])
def test_postprocess_default_branches(n_hot):
    """pre_nms_topk = 0 with A = 900 anchors: at most 512 boxes above the
    threshold takes the top-512 branch, more takes the all-anchor one.
    Boxes come in clusters so that NMS suppresses."""
    rng = np.random.RandomState(n_hot)
    A, nc = 900, 3
    centers = rng.uniform(20, 300, (40, 2))
    c = centers[rng.randint(0, 40, A)] + rng.randn(A, 2) * 3
    wh = rng.uniform(10, 40, (A, 2))
    obj = np.full(A, 0.05)
    obj[rng.permutation(A)[:n_hot]] = rng.uniform(0.5, 1.0, n_hot)
    cls = rng.uniform(0.3, 1.0, (A, nc))
    pred = np.concatenate([c, wh, obj[:, None], cls], -1)[None]
    pred = np.concatenate([pred, pred[:, rng.permutation(A)]], 0)
    valid = _postprocess_both(pred.astype(np.float32), nc, 0.1, 0)
    # boxes clustered round 40 centres: NMS suppresses some of them
    assert 0 < int(valid[0].sum()) < n_hot
