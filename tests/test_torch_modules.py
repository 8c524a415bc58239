"""The port's module path (``rvt_tpu_torch/models/layers.py`` forwards,
``RVTBackbone.forward``, ``models/detector.py:scan_backbone`` and the
entry points on configs the kernels do not take) against the JAX
package's flax modules and steps with ``fused_kernels`` off, on the CPU:
``preset("gen1", "tiny", resolution_hw=(64, 80))`` as shipped (f32) and
its bf16 twin. Weights reach the port through the weight bridge
(``convert/from_flax.py``), perturbed off the identity-ish init so the
attention blocks shape the output.

Tolerances. f32: both sides run the same f32 arithmetic in other orders:
states and outputs within 1e-4 of max|ref|, loss parts rtol 1e-3, each
gradient leaf within 1e-3 of max|ref|. bf16: the bounds of
``test_torch_train_step.py`` (XLA's and oneDNN's bf16 convolutions and
products round in other places, a bf16 ulp apart in a module's output,
which the four stages and the recurrence amplify): each module's output
within its H_ATOL (4e-2) of max|ref|, head outputs within
test_torch_raw_inference.py's bounds, the loss parts, gradients and the
class loss as test_torch_token_mask.py holds them (the head moves the
class logits of the few foreground anchors by a few percent). The final
states are held at 1.5x H_ATOL / C_ATOL: on the module path JAX's own
bf16 result is not defined closer than that. XLA keeps some bf16
intermediates in f32 (``xla_allow_excess_precision``, on by default);
with it off, JAX's stage-4 states of the single step's second call move
by 0.044 (h) and 0.054 (c), more than the port differs from JAX (0.042,
0.050; from the strict JAX 0.023, 0.038).
"""
import functools
from dataclasses import replace

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rvt_tpu.models.layers as jl
import rvt_tpu.training.losses as jlosses
import rvt_tpu_torch.models.layers as tl
import rvt_tpu_torch.training.losses as tlosses
from rvt_tpu.config import preset as j_preset
from rvt_tpu.convert.torch_ckpt import convert_state_dict
from rvt_tpu.inference import make_raw_inference_step as j_make_raw_step
from rvt_tpu.models import RVTDetector as JRVTDetector
from rvt_tpu.models.backbone import zero_states as j_zero_states
from rvt_tpu.models.detector import model_input_hw_c
from rvt_tpu.training import step as jstep
from rvt_tpu.training.optimizer import make_optimizer as j_make_optimizer
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.inference import make_raw_inference_step
from rvt_tpu_torch.models import detector as det
from rvt_tpu_torch.models.backbone import zero_states as t_zero_states
from rvt_tpu_torch.training import step as tstep
from rvt_tpu_torch.training.optimizer import make_optimizer
from tests.test_torch_train_step import (C_ATOL, H_ATOL, _batch,
                                         _j_geometric, _t_geometric,
                                         check_grads, check_losses)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes (the suite runs in
    parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T, B, K, M = 3, 2, 2, 4  # test_torch_train_step.py's window and labels
F32_TOL = 1e-4
BF16_STATE = 1.5  # x H_ATOL / C_ATOL: JAX's excess precision, above
LOSS_RTOL_F32 = 1e-3
GRAD_TOL_F32 = 1e-3
DTYPES = {"float32": (None, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# one field set off the shipped variant each: block and cell variants the
# kernels never take
VARIANTS = {
    "shipped": {},
    "gated": dict(mlp_gated=True, mlp_activation="silu", ls_init_value=0.0,
                  attention_bias=False, mlp_bias=False,
                  num_blocks=(2, 1, 1, 1), dws_conv=True),
    "dws_xh": dict(dws_conv=True, dws_conv_only_hidden=False,
                   mlp_activation="relu", norm_affine=False),
}


def _tol(compute):
    return F32_TOL if compute == "float32" else H_ATOL


def _with(cfg, compute, **fields):
    """``cfg`` (either package's) at ``compute`` with backbone, attention,
    LSTM or downsample fields set."""
    m = cfg.model
    bb = m.backbone
    groups = {"attention": bb.attention, "lstm": bb.lstm,
              "downsample": bb.downsample}
    sub = {g: {k: v for k, v in fields.items() if hasattr(c, k)}
           for g, c in groups.items()}
    top = {k: v for k, v in fields.items()
           if not any(k in s for s in sub.values())}
    bb = replace(bb, **top, **{g: replace(groups[g], **s)
                               for g, s in sub.items() if s})
    return replace(cfg, model=replace(m, compute_dtype=compute, backbone=bb))


def _cfg(preset_fn, compute, variant="shipped", conf=None):
    cfg = preset_fn("gen1", "tiny", resolution_hw=(64, 80),
                    sequence_length=T, max_labels_per_frame=M,
                    max_labeled_frames=K)
    cfg = _with(cfg, compute, **VARIANTS[variant])
    if conf is not None:
        pp = replace(cfg.model.postprocess, confidence_threshold=conf)
        cfg = replace(cfg, model=replace(cfg.model, postprocess=pp))
    return cfg


@functools.lru_cache(maxsize=None)
def _variables(variant):
    """Flax variables of the variant (f32 parameters at either compute
    dtype), perturbed by 0.05 randn from the flax init."""
    cfg = _cfg(j_preset, "float32", variant)
    model = JRVTDetector(cfg=cfg.model)
    x = jnp.zeros((1,) + model_input_hw_c(cfg.model), jnp.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), x,
                                    j_zero_states(cfg.model.backbone, 1))
    rng = np.random.RandomState(3)
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a) + 0.05 * rng.randn(*a.shape), a.dtype), variables)


@functools.lru_cache(maxsize=None)
def bridged(compute, variant="shipped"):
    """The JAX model and variables and the port's model with the same
    weights, loaded strictly through ``from_flax``."""
    cfg = _cfg(j_preset, compute, variant)
    variables = _variables(variant)
    tcfg = _cfg(t_preset, compute, variant)
    tmodel = det.init_detector(tcfg.model, device="cpu")
    tmodel.load_state_dict(from_flax(jax.tree.map(np.asarray, variables)),
                           strict=True)
    return cfg, JRVTDetector(cfg=cfg.model), variables, tcfg, tmodel


def _close(got, ref, tol):
    """max |got - ref| <= tol * max |ref|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-6), err


def _both(seed, *shape, compute="float32"):
    """One numpy-seeded input for both sides, in the compute dtype."""
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    jd, td = DTYPES[compute]
    return (jnp.asarray(a, jd or jnp.float32),
            torch.from_numpy(a).to(td))


# ---------------------------------------------------------------------------
# each module against its flax module
# ---------------------------------------------------------------------------

CASES = [(c, v) for c in DTYPES for v in VARIANTS]
IDS = [f"{c}-{v}" for c, v in CASES]


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "sigmoid",
                                  "tanh"])
def test_activations_match_jax(name):
    jx, tx = _both(0, 300)
    _close(tl._act(name)(tx), jl._act(name)(jx), 1e-6)


@pytest.mark.parametrize("compute,variant", CASES, ids=IDS)
def test_attention_modules_match_flax(compute, variant):
    """SelfAttentionCl, MLP (GLU when gated), the grid PartitionAttention
    block (LayerScale when the variant has it) and the
    MaxVitAttentionPair of every stage-1 block (window then grid), on the
    same numpy inputs."""
    cfg, _, variables, tcfg, tmodel = bridged(compute, variant)
    jd, td = DTYPES[compute]
    a = cfg.model.backbone.attention
    H, W, C = det.stage_geometries(tcfg.model)[0]
    tol = _tol(compute)
    sp = variables["params"]["backbone"]["stage1"]
    stage = tmodel.backbone.stages[0]
    jx, tx = _both(1, B, H, W, C, compute=compute)
    blk = sp["block0"]["att_window"]
    tok_j, tok_t = _both(2, B * 4, 40, C, compute=compute)
    ja = jl.SelfAttentionCl(dim=C, dim_head=a.dim_head,
                            bias=a.attention_bias, dtype=jd)
    _close(stage.att_blocks[0].att_window.self_attn(tok_t, td),
           jax.jit(ja.apply)({"params": blk["self_attn"]}, tok_j), tol)
    jm = jl.MLP(dim=C, expansion_ratio=a.mlp_ratio, act=a.mlp_activation,
                gated=a.mlp_gated, bias=a.mlp_bias, dtype=jd)
    _close(stage.att_blocks[0].att_window.mlp(tx, td),
           jax.jit(jm.apply)({"params": blk["mlp"]}, jx), tol)
    jp = jl.PartitionAttention(dim=C, partition_window=False, cfg=a,
                               dtype=jd)
    _close(stage.att_blocks[0].att_grid(tx, td),
           jax.jit(jp.apply)({"params": sp["block0"]["att_grid"]}, jx), tol)
    for j, tblk in enumerate(stage.att_blocks):
        jpair = jl.MaxVitAttentionPair(dim=C, cfg=a, skip_first_norm=j == 0,
                                       dtype=jd)
        _close(tblk(tx, td), jax.jit(jpair.apply)(
            {"params": sp[f"block{j}"]}, jx), tol)


@pytest.mark.parametrize("compute,variant", CASES, ids=IDS)
def test_downsample_and_cell_match_flax(compute, variant):
    """ConvDownsample (the stem, s2d-blocked and not, and stage 2) and
    DWSConvLSTM2d (1x1, or with the depthwise conv over h or [x, h])."""
    cfg, _, variables, tcfg, tmodel = bridged(compute, variant)
    jd, td = DTYPES[compute]
    bb = cfg.model.backbone
    tol = _tol(compute)
    sp = variables["params"]["backbone"]
    stages = tmodel.backbone.stages
    Hi, Wi = bb.in_res_hw
    ev = np.random.RandomState(4).randint(0, 5, (B, Hi, Wi, 20))
    for s2d in (False, True):
        from rvt_tpu.ops.s2d import host_space_to_depth

        x = jnp.asarray(host_space_to_depth(ev, (Hi, Wi)) if s2d else ev,
                        jnp.uint8)
        jds = jl.ConvDownsample(dim_out=bb.stage_dims[0],
                                downsample_factor=bb.stem_patch_size,
                                cfg=bb.downsample, dtype=jd, s2d_input=s2d,
                                in_channels=bb.input_channels)
        _close(stages[0].downsample_cf2cl(torch.tensor(np.asarray(x)),
                                          td, s2d),
               jds.apply({"params": sp["stage1"]["downsample"]}, x), tol)
    H, W, C = det.stage_geometries(tcfg.model)[0]
    jx, tx = _both(5, B, H, W, C, compute=compute)
    jds = jl.ConvDownsample(dim_out=bb.stage_dims[1], downsample_factor=2,
                            cfg=bb.downsample, dtype=jd)
    _close(stages[1].downsample_cf2cl(tx, td),
           jds.apply({"params": sp["stage2"]["downsample"]}, jx), tol)
    jh, th = _both(6, B, H, W, C)
    jc, tc = _both(7, B, H, W, C)
    jcell = jl.DWSConvLSTM2d(dim=C, cfg=bb.lstm, dtype=jd)
    hr, cr = jcell.apply({"params": sp["stage1"]["lstm"]}, jx, (jh, jc))
    hg, cg = stages[0].lstm(tx, (th, tc), td)
    assert hg.dtype == cg.dtype == torch.float32
    _close(hg, hr, tol)
    _close(cg, cr, tol)


@pytest.mark.parametrize("variant", ["gated", "dws_xh"])
def test_bridge_round_trip(variant):
    """flax -> ``from_flax`` -> the port's strict ``load_state_dict`` ->
    the JAX package's ``convert_state_dict`` gives the flax variables back:
    the GLU (``mlp.net.0.proj``), ``lstm.conv3x3_dws``, block 1, and no
    ``ls1``/``ls2`` at ls_init_value 0."""
    _, _, variables, _, tmodel = bridged("float32", variant)
    sd = tmodel.state_dict()
    names = set(sd)
    if variant == "gated":
        assert ("backbone.stages.0.att_blocks.1.att_grid.mlp.net.0.proj."
                "weight") in names
        assert not any(".ls1." in n or ".ls2." in n for n in names)
    assert "backbone.stages.0.lstm.conv3x3_dws.weight" in names
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, variables["params"]))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back["params"])[0])
    assert len(got) == len(ref)
    for path, v in ref:
        np.testing.assert_array_equal(np.asarray(got[path]), v)


def test_new_parameters_initialised_as_jax():
    """``_init_weights`` on the new parameters: the GLU and depthwise
    kernels lecun-normal (truncated, fan-in of a depthwise kernel k*k),
    their biases zero, no LayerScale at ls_init_value 0."""
    tcfg = _cfg(t_preset, "float32", "gated")
    m = det.init_detector(tcfg.model, seed=1, device="cpu")
    glu = m.backbone.stages[3].att_blocks[0].att_grid.mlp.net[0].proj
    dws = m.backbone.stages[3].lstm.conv3x3_dws
    for w, fan_in in ((glu.weight, glu.weight.shape[1]), (dws.weight, 9)):
        std = float(w.detach().std())
        assert abs(std / (fan_in ** -0.5) - 1) < 0.1, std
        assert float(w.detach().abs().max()) <= 2 * fan_in ** -0.5 / 0.8796
    assert float(dws.bias.detach().abs().max()) == 0.0
    assert glu.bias is None  # mlp_bias False


# ---------------------------------------------------------------------------
# dropout: statistics over a seeded generator
# ---------------------------------------------------------------------------


def test_dropout_modules_keep_rate_and_scale():
    """DropPath per sample, MLP dropout and cell-update dropout per
    element: kept with probability 1 - rate (within 4 sigma), scaled by
    1 / (1 - rate); deterministic or rate 0 returns the input; a rate
    above 0 without a generator raises, as flax does without an rng."""
    g = torch.Generator().manual_seed(0)
    rate, keep = 0.3, 0.7
    x = torch.ones(4000, 2, 2, 3)
    y = tl.drop_path(x, rate, False, g)
    per = y.reshape(4000, -1)
    assert bool(((per == 0).all(1)
                 | (per == torch.tensor(1 / keep)).all(1)).all())
    frac = float((per[:, 0] != 0).float().mean())
    assert abs(frac - keep) < 4 * (keep * rate / 4000) ** 0.5
    z = torch.ones(200, 300)
    y = tl.dropout(z, rate, False, g)
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / keep]))
    frac = float((y != 0).float().mean())
    assert abs(frac - keep) < 4 * (keep * rate / z.numel()) ** 0.5
    assert tl.dropout(z, rate, True, None) is z
    assert tl.drop_path(x, 0.0, False, None) is x
    with pytest.raises(RuntimeError, match="Generator"):
        tl.dropout(z, rate, False, None)
    # the modules draw from the generator they are given
    a = replace(t_preset("gen1", "tiny").model.backbone.attention,
                drop_mlp=rate, partition_size=(2, 2), dim_head=8)
    mlp = tl.MLP(8, 4, drop_prob=rate)
    with torch.no_grad():
        mlp.net[2].weight.fill_(0)
        mlp.net[2].weight[:, 0] = 1
        mlp.net[2].bias.fill_(0)
        mlp.net[0][0].weight.fill_(0)
        mlp.net[0][0].bias.fill_(3.0)
    with torch.no_grad():
        out = mlp(torch.ones(5000, 8), torch.float32, False, g)[:, 0]
    assert abs(float((out != 0).float().mean()) - keep) < 0.03
    np.testing.assert_allclose(out[out != 0].numpy(),
                               float(torch.nn.functional.gelu(
                                   torch.tensor(3.0))) / keep, rtol=1e-6)
    with pytest.raises(RuntimeError, match="MLP dropout"):
        tl.PartitionAttention(8, a, True)(torch.ones(1, 2, 2, 8),
                                          torch.float32, False)
    lcfg = replace(t_preset("gen1", "tiny").model.backbone.lstm,
                   drop_cell_update=rate)
    cell = tl.DWSConvLSTM2d(4, lcfg)
    with torch.no_grad():
        cell.conv1x1.weight.fill_(0)
        cell.conv1x1.bias.fill_(5.0)  # gates ~1, cell input tanh(5)
    zero = torch.zeros(1000, 4, 4, 4)
    with torch.no_grad():
        _, c = cell(zero, (zero, zero), torch.float32, False, g)
    kept = c != 0
    assert abs(float(kept.float().mean()) - keep) < 0.01
    s = torch.sigmoid(torch.tensor(5.0))
    np.testing.assert_allclose(c[kept].numpy(), float(
        s * torch.tanh(torch.tensor(5.0)) / keep), rtol=1e-5)
    with torch.no_grad():
        _, c0 = cell(zero, (zero, zero), torch.float32, True)
    assert bool((c0 != 0).all())


# ---------------------------------------------------------------------------
# the entry points against JAX's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def serve_runs(compute):
    """Two carried calls each of the single step (``__call__``), the
    streaming eval step and the raw step, on both sides."""
    cfg, model, variables, tcfg, tmodel = bridged(compute)
    rng = np.random.RandomState(0)
    out = {"single": [], "eval": [], "raw": []}
    # single step, uint8 frames as f32
    japply = jax.jit(model.apply)
    jst = j_zero_states(cfg.model.backbone, B)
    tst = t_zero_states(tcfg.model.backbone, B, device="cpu")
    for _ in range(2):
        x = rng.randint(0, 6, (B,) + tuple(tcfg.model.backbone.in_res_hw)
                        + (20,)).astype(np.float32)
        jp, jst = japply(variables, jnp.asarray(x), jst)
        with torch.inference_mode():
            tp, tst = tmodel(torch.from_numpy(x), tst)
        out["single"].append((jp, jst, tp, tst))
    # eval step over windows of T frames, labels on the last two
    jeval = jstep.make_eval_step(model, cfg)
    teval = tstep.make_eval_step(tmodel, tcfg)
    jst = j_zero_states(cfg.model.backbone, B)
    tst = t_zero_states(tcfg.model.backbone, B, device="cpu")
    fv = np.zeros((B, T), bool)
    fv[:, 1:] = True
    for first in (True, False):
        ev = rng.randint(0, 6, (B, T, 64, 80, 20)).astype(np.uint8)
        is_first = np.full(B, first)
        jr = jeval(variables, jst, jnp.asarray(ev), jnp.asarray(fv),
                   jnp.asarray(is_first))
        jst = jr[0]
        tr = teval(tst, torch.from_numpy(ev), torch.from_numpy(fv),
                   torch.from_numpy(is_first))
        tst = tr.states
        out["eval"].append((jr, tr))
    # raw step: the Pallas voxelizer in interpret mode on the JAX side
    H, W = cfg.dataset.resolution_hw
    jraw = j_make_raw_step(model, cfg, use_pallas_voxelizer=True,
                           interpret=True)
    traw = make_raw_inference_step(tmodel, tcfg)
    jst = j_zero_states(cfg.model.backbone, B)
    tst = t_zero_states(tcfg.model.backbone, B, device="cpu")
    for first, n in ((True, 700), (False, 900)):
        ev = [rng.randint(0, hi, (B, 1024)).astype(np.int32)
              for hi in (W, H, 2)]
        ev.append(np.sort(rng.randint(0, 50_000, (B, 1024)), 1).astype(
            np.int32))
        counts = np.array([n, 1024], np.int32)
        is_first = np.full(B, first)
        jr = jraw(variables, jst, *(jnp.asarray(a) for a in ev),
                  jnp.asarray(counts), jnp.asarray(is_first))
        jst = jr[0]
        tr = traw(tst, *(torch.from_numpy(a) for a in ev + [counts]),
                  torch.from_numpy(is_first))
        tst = tr[0]
        out["raw"].append((jr, tr))
    return out


def _states_close(jst, tst, compute):
    for (hr, cr), (hg, cg) in zip(jst, tst):
        assert hg.dtype == cg.dtype == torch.float32
        if compute == "float32":
            _close(hg, hr, F32_TOL)
            _close(cg, cr, F32_TOL)
        else:
            np.testing.assert_allclose(hg.numpy(), np.asarray(hr),
                                       atol=BF16_STATE * H_ATOL)
            np.testing.assert_allclose(cg.numpy(), np.asarray(cr),
                                       atol=BF16_STATE * C_ATOL)


def _preds_close(tp, jp, compute):
    if compute == "float32":
        _close(tp, jp, F32_TOL)
        return
    ref, out = np.asarray(jp, np.float32), tp.numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() < 0.05 * max(np.abs(ref).max(), 1.0)
    assert np.abs(out - ref).mean() < 5e-3 * max(np.abs(ref).mean(), 1.0)


@pytest.mark.parametrize("compute", list(DTYPES))
def test_single_step_matches_jax(compute):
    """``RVTDetector.forward`` on the module path against the JAX module's
    ``__call__``: head outputs and states over two carried steps."""
    for jp, jst, tp, tst in serve_runs(compute)["single"]:
        _preds_close(tp, jp, compute)
        _states_close(jst, tst, compute)


@pytest.mark.parametrize("compute", list(DTYPES))
def test_eval_step_matches_jax(compute):
    """The streaming eval step over two carried windows: final states,
    the gathered frames and their validity, the detections."""
    for jr, tr in serve_runs(compute)["eval"]:
        _states_close(jr[0], tr.states, compute)
        np.testing.assert_array_equal(tr.frame_idx.numpy(), jr[3])
        np.testing.assert_array_equal(tr.gval.numpy(), jr[4])
        np.testing.assert_array_equal(tr.det_valid.numpy(), jr[2])
        assert torch.isfinite(tr.preds).all()


@pytest.mark.parametrize("compute", list(DTYPES))
def test_raw_step_matches_jax(compute):
    """The raw-event step over two carried calls (the voxelizer, then the
    single step on the modules): states and the detections' validity."""
    for jr, tr in serve_runs(compute)["raw"]:
        _states_close(jr[0], tr[0], compute)
        np.testing.assert_array_equal(tr[2].numpy(), jr[2])


@functools.lru_cache(maxsize=None)
def train_runs(compute):
    """Two carried train steps on both sides from the bridged weights,
    with test_torch_train_step.py's geometric assignment; JAX's gradient
    read from its Adam moment as there."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlosses, "simota_assign", _j_geometric)
    mp.setattr(tlosses, "simota_assign", _t_geometric)
    try:
        return _train(compute)
    finally:
        mp.undo()


def _train(compute):
    import copy

    cfg, model, variables, tcfg, tmodel = bridged(compute)
    tmodel = copy.deepcopy(tmodel)
    opt = j_make_optimizer(cfg.training)
    params = variables["params"]
    state = jstep.TrainState(params=params,
                             batch_stats=variables["batch_stats"],
                             opt_state=opt.init(params),
                             step=jnp.zeros((), jnp.int32))
    moved = copy.deepcopy(tmodel)
    with torch.no_grad():
        w = moved.backbone.stages[0].downsample_cf2cl.conv.weight
        w.mul_(1 + 1e-3 * torch.from_numpy(
            np.random.RandomState(9).randn(*w.shape)).float())
    jtrain = jstep.make_train_step(model, cfg, opt, donate=False)
    ttrain = tstep.make_train_step(tmodel, tcfg, make_optimizer(
        tmodel.parameters(), tcfg.training))
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(2)]
    firsts = [np.array([True, False]), np.array([False, False])]
    jst = j_zero_states(cfg.model.backbone, B)
    tst = tuple((torch.zeros(h.shape), torch.zeros(c.shape)) for h, c in jst)
    jout, tout, grads = [], [], None
    for (ev, labels, mask, fv), first in zip(batches, firsts):
        state, jst, jm = jtrain(state, jst, jnp.asarray(ev),
                                jnp.asarray(labels), jnp.asarray(mask),
                                jnp.asarray(fv), jnp.asarray(first))
        jout.append(jax.tree.map(np.asarray, (jst, jm)))
        tst, tm = ttrain(tst, *(torch.from_numpy(a)
                                for a in (ev, labels, mask, fv, first)))
        tout.append((tst, {k: float(v) for k, v in tm.items()}))
        if grads is None:
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
        torch.from_numpy(firsts[0]))
    moved_grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in moved.named_parameters()}
    return dict(jout=jout, tout=tout, grads=grads + (moved_grads,))


@pytest.mark.parametrize("compute", list(DTYPES))
def test_train_steps_match_jax(compute):
    """Two carried train steps on the module path (every step under
    checkpoint) against JAX's ``make_train_step`` with ``fused_kernels``
    off: loss parts, final states, every gradient leaf."""
    runs = train_runs(compute)
    if compute == "bfloat16":
        check_losses(runs, cls_of_loss=True)
        for (jst, _), (tst, _) in zip(runs["jout"], runs["tout"]):
            _states_close(jst, tst, compute)
        check_grads(runs)
        return
    for (jst, jm), (tst, tm) in zip(runs["jout"], runs["tout"]):
        for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg",
                  "grad_norm"):
            np.testing.assert_allclose(tm[k], float(jm[k]),
                                       rtol=LOSS_RTOL_F32, err_msg=k)
        _states_close(jst, tst, compute)
    jg, tg, _ = runs["grads"]
    assert set(jg) == set(tg)
    for name, ref in jg.items():
        _close(tg[name], ref.numpy(), GRAD_TOL_F32)


def test_train_step_refuses_dropout_as_jax():
    """JAX's train step passes its modules no 'dropout' rng: with a rate
    above 0 its first call raises (flax ``InvalidRngError``); the port's
    train step raises when it is made, naming the rate."""
    from flax.errors import InvalidRngError

    cfg = _cfg(j_preset, "float32")
    jcfg = _with(cfg, "float32", drop_path=0.1)
    model = JRVTDetector(cfg=jcfg.model)
    _, _, variables, _, _ = bridged("float32")
    ev = jnp.zeros((1, 1) + model_input_hw_c(cfg.model), jnp.float32)
    with pytest.raises(InvalidRngError):
        jax.eval_shape(lambda v: det_scan(model, v, ev), variables)
    tcfg = _with(_cfg(t_preset, "float32"), "float32", drop_path=0.1)
    tmodel = det.init_detector(tcfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match="drop_path"):
        tstep.make_train_step(tmodel, tcfg, make_optimizer(
            tmodel.parameters(), tcfg.training))


def det_scan(model, variables, ev):
    from rvt_tpu.models.detector import scan_backbone

    return scan_backbone(model, variables, ev,
                         j_zero_states(model.cfg.backbone, 1),
                         deterministic=False, remat=True)
