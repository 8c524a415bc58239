"""The port's raw-event path (rvt_tpu_torch, plain PyTorch versions on the
CPU) against the JAX package at a tiny geometry: the per-step stage
``fused_stage`` against the Pallas ``fused_stage`` in interpret mode, the
single-step detector against ``model.apply``, and the whole
``make_raw_inference_step`` against JAX's over two calls with the states
carried. Weights reach the port through the weight bridge."""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.config import preset
from rvt_tpu.inference import make_raw_inference_step as j_make_raw_step
from rvt_tpu.models import RVTDetector, zero_states
from rvt_tpu.models.detector import model_input_hw_c
from rvt_tpu.ops import fused_attention as jfa
from rvt_tpu.training.step import reset_states as j_reset
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.inference import event_frames, make_raw_inference_step
from rvt_tpu_torch.models.backbone import zero_states as t_zero_states
from rvt_tpu_torch.models.detector import backbone_kernel_params
from rvt_tpu_torch.models.detector import init_detector as t_init_detector
from rvt_tpu_torch.ops import fused_attention as tfa
from rvt_tpu_torch.ops.fused_scan import fused_stage
from rvt_tpu_torch.training.step import reset_states as t_reset

B, N = 2, 1024


def _raw_cfg(preset_fn, dataset, resolution_hw):
    cfg = preset_fn(dataset, "tiny", resolution_hw=resolution_hw,
                    sequence_length=2, max_labels_per_frame=4)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         stem_s2d=False)))


def _models(dataset, resolution_hw):
    """The JAX model and variables (perturbed off the identity-ish init, as
    test_torch_slice.py does) and the port's model with the same weights."""
    cfg = _raw_cfg(preset, dataset, resolution_hw)
    model = RVTDetector(cfg=cfg.model)
    # a jitted init (eager init compiles op by op: most of a minute)
    x = jnp.zeros((B,) + model_input_hw_c(cfg.model), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x,
                                    zero_states(cfg.model.backbone, B))
    variables = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * np.random.RandomState(
            3).randn(*a.shape), a.dtype), variables)
    tcfg = _raw_cfg(t_preset, dataset, resolution_hw)
    tmodel = t_init_detector(tcfg.model, device="cpu")
    tmodel.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return cfg, model, variables, tcfg, tmodel


def _events(seed, H, W, counts):
    rng = np.random.RandomState(seed)
    x, y, p, t = (np.zeros((B, N), np.int32) for _ in range(4))
    for b, n in enumerate(counts):
        x[b, :n] = rng.randint(0, W, n)
        y[b, :n] = rng.randint(0, H, n)
        p[b, :n] = rng.randint(0, 2, n)
        t[b, :n] = np.sort(rng.randint(0, 50_000, n))
    return x, y, p, t, np.asarray(counts, np.int32)


@pytest.fixture(scope="module")
def gen1_run():
    """Two raw steps of both implementations, states carried; and each
    step's voxelized frame through both single-step detectors."""
    cfg, model, variables, tcfg, tmodel = _models("gen1", (64, 80))
    H, W = cfg.dataset.resolution_hw
    jstep = j_make_raw_step(model, cfg, use_pallas_voxelizer=True,
                            interpret=True)
    japply = jax.jit(model.apply)
    tstep = make_raw_inference_step(tmodel, tcfg)
    params = backbone_kernel_params(tmodel)
    jstates = zero_states(cfg.model.backbone, B)
    tstates = t_zero_states(tcfg.model.backbone, B, device="cpu")
    calls = []
    for seed, counts, first in ((0, [700, 500], True),
                                (1, [1024, 300], False)):
        ev = _events(seed, H, W, counts)
        is_first = np.full(B, first)
        # the single-step detector on this call's frame, from the same
        # states, before either step moves them
        frames = event_frames(*(torch.from_numpy(a) for a in ev), tcfg)
        jpreds, _ = japply(variables,
                           jnp.asarray(frames.numpy(), jnp.float32),
                           j_reset(jstates, jnp.asarray(is_first)))
        with torch.inference_mode():
            tpreds, _ = tmodel(frames,
                               t_reset(tstates, torch.from_numpy(is_first)),
                               params)
        jstates, jdets, jvalid = jstep(
            variables, jstates, *(jnp.asarray(a) for a in ev),
            jnp.asarray(is_first))
        tstates, tdets, tvalid = tstep(
            tstates, *(torch.from_numpy(a) for a in ev),
            torch.from_numpy(is_first))
        calls.append(dict(jstates=jstates, tstates=tstates, jdets=jdets,
                          tdets=tdets, jvalid=jvalid, tvalid=tvalid,
                          jpreds=jpreds, tpreds=tpreds))
    return tcfg, calls


@pytest.mark.parametrize("call", [0, 1], ids=["first", "carried"])
def test_raw_step_states_match_jax(gen1_run, call):
    _, calls = gen1_run
    c = calls[call]
    for (hr, cr), (hg, cg) in zip(c["jstates"], c["tstates"]):
        assert hg.dtype == cg.dtype == torch.float32
        np.testing.assert_allclose(hg.numpy(), np.asarray(hr), atol=4e-2)
        np.testing.assert_allclose(cg.numpy(), np.asarray(cr), atol=8e-2)


@pytest.mark.parametrize("call", [0, 1], ids=["first", "carried"])
def test_raw_step_detections_shape_and_finite(gen1_run, call):
    tcfg, calls = gen1_run
    c = calls[call]
    md = tcfg.model.postprocess.max_detections
    assert tuple(c["tdets"].shape) == (B, md, 7) == c["jdets"].shape
    assert tuple(c["tvalid"].shape) == (B, md) == c["jvalid"].shape
    assert c["tvalid"].dtype == torch.bool
    assert torch.isfinite(c["tdets"]).all()


@pytest.mark.parametrize("call", [0, 1], ids=["first", "carried"])
def test_single_step_detector_matches_model_apply(gen1_run, call):
    """RVTDetector.forward against the JAX module's __call__ on the same
    voxelized frame and states: head outputs within the tolerances of
    test_torch_slice.py (bf16 rounding order only)."""
    _, calls = gen1_run
    ref = np.asarray(calls[call]["jpreds"], np.float32)
    out = calls[call]["tpreds"].numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    scale = max(np.abs(ref).mean(), 1.0)
    assert np.abs(out - ref).max() < 0.05 * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).mean() < 5e-3 * scale


def test_fused_stage_matches_jax():
    """The port's per-step stage (pair over B frames, then K4 at T = 1)
    against the TPU's one-kernel ``fused_stage`` on a layer-normed bf16
    input and a nonzero carry; 4e-2 (h) and 8e-2 (c), as the stage scan's
    test holds it."""
    from tests.test_torch_attention import C, DH, H, PART, W, _pair_weights

    p, pair = _pair_weights(True)
    rng = np.random.RandomState(5)
    x = rng.randn(B, H, W, C).astype(np.float32)
    lw = (rng.randn(2 * C, 4 * C) * 0.05).astype(np.float32)
    lb = (rng.randn(4 * C) * 0.05).astype(np.float32)
    h0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)
    c0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)
    bf = jnp.bfloat16
    hr, cr = jfa.fused_stage(
        jnp.asarray(x, bf), jfa.attention_block_params(p["att_window"], True),
        jfa.attention_block_params(p["att_grid"], False),
        jnp.asarray(lw, bf), jnp.asarray(lb, bf).reshape(1, -1),
        jnp.asarray(h0), jnp.asarray(c0), heads=C // DH, dim_head=DH,
        part=PART, skip_first_norm=True, eps=1e-5, interpret=True)
    t = torch.from_numpy
    hg, cg = fused_stage(
        t(x).bfloat16(), tfa.attention_block_params(pair.att_window, True),
        tfa.attention_block_params(pair.att_grid, False), t(lw).bfloat16(),
        t(lb).bfloat16(), t(h0), t(c0), heads=C // DH, dim_head=DH,
        part=PART, eps=1e-5)
    assert hg.dtype == cg.dtype == torch.float32
    np.testing.assert_allclose(hg.numpy(), np.asarray(hr), atol=4e-2)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cr), atol=8e-2)


def test_gen4_ds2_direct_matches_downsample_path():
    """gen4 (downsample_by_factor_2): the port's raw step voxelizing
    straight into the half grid gives the same states and detections as
    voxelizing the full sensor and downsampling, as tests/test_ops.py
    checks the JAX step."""
    tcfg = _raw_cfg(t_preset, "gen4", (48, 64))
    assert tcfg.dataset.downsample_by_factor_2
    tmodel = t_init_detector(tcfg.model, seed=0, device="cpu")
    ev = _events(1, 48, 64, [900, 1024])
    ev[0][0, :20] = -1  # dropped in both branches
    outs = []
    for direct in (True, False):
        step = make_raw_inference_step(tmodel, tcfg, ds2_direct=direct)
        outs.append(step(t_zero_states(tcfg.model.backbone, B, device="cpu"),
                         *(torch.from_numpy(a) for a in ev),
                         torch.ones(B, dtype=torch.bool)))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][2], outs[1][2])
