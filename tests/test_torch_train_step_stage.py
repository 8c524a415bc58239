"""Row 7 of the kernel table: the port's per-step train stage
(``rvt_tpu_torch.ops.fused_train.fused_stage_step_train``, the kernels'
plain versions on the CPU) against the JAX package's
``fused_stage_step_train`` (interpret mode) under a ``lax.scan``, and
against the port's own whole-window ``split_stage_scan_train``, at
(16, 10, 32), partition (8, 10), dh 32, T = 3, B = 2; the per-step
backbone (``fused_train_scan_backbone(per_step=True)``) against JAX's at
gen1 tiny; and the per-step envelope against ``train_stage_mode``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.ops import fused_train as jft
from rvt_tpu_torch.ops import fused_train as tft
from tests.test_torch_train_ops import _block, _jax, _rel, _torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

H, W, C, PART, DH = 16, 10, 32, (8, 10), 32
T, B = 3, 2
EPS = 1e-5

# Tolerances, relative to max |ref|. The forward: rows 9 and 10's
# tolerance (the same kernels, step by step). The gradients: the JAX
# package's own bound for its per-step path against its whole-window scan
# (tests/test_fused_train.py: T bf16 ulps of per-step weight-gradient
# accumulation in bf16).
FWD_TOL = 1.2e-2
GRAD_TOL = 2e-2


def _loss(h_seq, hT, cT, wh, wT):
    """The linear loss of tests/test_fused_train.py:308-311."""
    if isinstance(hT, torch.Tensor):
        wh, wT = torch.from_numpy(wh), torch.from_numpy(wT)
        return ((h_seq.float() * wh).sum() + (hT * wT).sum()
                + 0.5 * (torch.tanh(cT) * wT).sum())
    return (jnp.sum(h_seq.astype(jnp.float32) * wh) + jnp.sum(hT * wT)
            + 0.5 * jnp.sum(jnp.tanh(cT) * wT))


def _port_per_step(cfg, x_seq, ds_s, ds_b, win, grid, lw, lb, h0, c0):
    h, c = h0, c0
    hs = []
    for t in range(x_seq.shape[0]):
        h, c = tft.fused_stage_step_train(cfg, x_seq[t], ds_s, ds_b, win,
                                          grid, lw, lb, h, c)
        hs.append(h.to(torch.bfloat16))
    return torch.stack(hs), h, c


def _port_window(cfg, *args):
    return tft.split_stage_scan_train(cfg, *args)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(1)

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    x = bf(rng.randn(T, B, H, W, C))
    ds = [(bf(1 + 0.1 * rng.randn(C)), "bf16"), (bf(0.1 * rng.randn(C)),
                                                 "bf16")]
    win, grid = _block(rng, True), _block(rng, False)
    lw = (bf(rng.randn(2 * C, 4 * C) * (2 * C) ** -0.5), "bf16")
    lb = (bf(0.1 * rng.randn(4 * C)), "bf16")
    h0 = ((rng.randn(B, H, W, C) * 0.3).astype(np.float32), "f32")
    c0 = ((rng.randn(B, H, W, C) * 0.3).astype(np.float32), "f32")
    wh = rng.randn(T, B, H, W, C).astype(np.float32)
    wT = rng.randn(B, H, W, C).astype(np.float32)
    leaves = [(x, "bf16")] + ds + win + grid + [lw, lb, h0, c0]
    nw = len(win)

    def split(a):
        return (a[0], a[1], a[2], tuple(a[3:3 + nw]),
                tuple(a[3 + nw:3 + nw + len(grid)]), *a[-4:])

    # JAX: lax.scan over the per-step kernel (interpret mode)
    jcfg = (C // DH, DH, PART, EPS, EPS, False, True)

    def jrun(*a):
        x_seq, ds_s, ds_b, w_, g_, lw_, lb_, h0_, c0_ = split(a)

        def body(carry, x_t):
            h_t, c_t = jft.fused_stage_step_train(jcfg, x_t, ds_s, ds_b, w_,
                                                  g_, lw_, lb_, *carry)
            return (h_t, c_t), h_t.astype(jnp.bfloat16)
        (hT, cT), h_seq = jax.lax.scan(body, (h0_, c0_), x_seq)
        return _loss(h_seq, hT, cT, wh, wT), (h_seq, hT, cT)

    jargs = [_jax(a, k) for a, k in leaves]
    (_, jout), jg = jax.value_and_grad(
        jrun, argnums=tuple(range(len(jargs))), has_aux=True)(*jargs)

    tcfg = tft.StageCfg(C // DH, DH, PART, EPS, EPS)
    outs, grads = {}, {}
    for name, fn in (("step", _port_per_step), ("window", _port_window)):
        targs = [_torch(a, k) for a, k in leaves]
        out = fn(tcfg, *split(targs))
        _loss(*out, wh, wT).backward()
        outs[name] = [o.detach() for o in out]
        grads[name] = [a.grad for a in targs]
    return (jax.tree.map(np.asarray, jout), [np.asarray(g, np.float32)
                                             for g in jg], outs, grads)


def test_step_stage_forward_matches_jax(case):
    jout, _, outs, _ = case
    for name, t, j in zip(("h_seq", "h_T", "c_T"), outs["step"], jout):
        assert _rel(t.float().numpy(), j) < FWD_TOL, name


def test_step_stage_grads_match_jax(case):
    _, jg, _, grads = case
    assert len(jg) == len(grads["step"]) == 33
    for i, (t, j) in enumerate(zip(grads["step"], jg)):
        assert t is not None and np.abs(j).max() > 0, i
        err = _rel(t.float().numpy(), j)
        assert err < GRAD_TOL, (i, err)


def test_step_stage_matches_whole_window(case):
    """The same kernels step by step: the forward equals the whole-window
    stage bit for bit (tests/test_fused_train.py:303-306); the gradients
    differ by the bf16 accumulation of the weight gradients over t."""
    _, _, outs, grads = case
    for a, b in zip(outs["step"], outs["window"]):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(grads["step"], grads["window"])):
        assert a.dtype == b.dtype
        assert _rel(a.float().numpy(), b.float().numpy()) < GRAD_TOL, i


@pytest.mark.parametrize("dataset,size", [("gen1", "base"),
                                          ("gen4", "base"),
                                          ("gen1", "tiny"),
                                          ("gen4", "small")])
def test_per_step_envelope_matches_jax(dataset, size):
    """Where the JAX package trains a stage per step on its kernels
    (gen4 stage 1 it runs on its XLA modules), and so where the port's
    per-step path runs."""
    from rvt_tpu_torch.config import preset

    bb = preset(dataset, size).model.backbone
    Hi, Wi = bb.in_res_hw
    part = tuple(bb.attention.partition_size)
    for s, C_ in zip(bb.strides, bb.stage_dims):
        geo = (Hi // s, Wi // s, C_)
        assert tft.train_stage_ok(*geo, part, scan=False) == (
            jft.train_stage_mode(*geo, part, scan=False) is not None), geo


def test_per_step_backbone_matches_jax():
    """``fused_train_scan_backbone(per_step=True)`` at gen1 tiny against
    JAX's per-step scan (``lax.scan`` over its ``fused_stage_step_train``)
    under test_torch_train_backbone.py's linear loss: features and states
    at its FWD_TOL, every backbone leaf at its GRAD_TOL."""
    from tests.test_torch_train_backbone import (backbone_case, check_forward,
                                                 check_grads)

    case = backbone_case(per_step=True)
    check_forward(case)
    check_grads(case)


def test_per_step_backbone_raises_outside_the_envelope(monkeypatch):
    """gen4 stage 1 (96x160x64): JAX trains it per step on its XLA
    modules, and the port routes it to its modules per step (over the
    window both take the kernels). At a reduced geometry, gen1 tiny with
    both packages' per-step bound ``_SPLIT_MIN`` set just below stage 1's
    elements (as the JAX package's tests move its envelope), JAX's
    ``train_stage_mode`` and the port's routing agree that stage 1 leaves
    the kernels per step: the per-step backbone runs it on the module
    pair and cell, forward and backward under checkpoint, with finite
    gradients, and row 7 once per step at the other stages (the name is
    from when the port raised here)."""
    from dataclasses import replace

    import rvt_tpu_torch.models.detector as det
    import rvt_tpu_torch.models.layers as tl
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.backbone import zero_states

    cfg = preset("gen4", "base")
    cfg = replace(cfg.model, compute_dtype="bfloat16", backbone=replace(
        cfg.model.backbone, fused_kernels=True))
    assert det.stage_routes(cfg, "train_per_step") == (
        ["modules"] + ["kernels"] * 3)
    assert det.stage_routes(cfg, "train") == ["kernels"] * 4

    cfg = preset("gen1", "tiny", resolution_hw=(64, 80))
    cfg = replace(cfg.model, compute_dtype="bfloat16", backbone=replace(
        cfg.model.backbone, fused_kernels=True))
    geo = det.stage_geometries(cfg)
    part = tuple(cfg.backbone.attention.partition_size)
    bound = geo[0][0] * geo[0][1] * geo[0][2] - 1
    monkeypatch.setattr(tft, "_SPLIT_MIN", bound)
    monkeypatch.setattr(jft, "_SPLIT_MIN", bound)
    assert [jft.train_stage_mode(*g, part, scan=False) is None
            for g in geo] == [True, False, False, False]
    assert det.stage_routes(cfg, "train_per_step") == (
        ["modules"] + ["kernels"] * 3)
    calls, pairs = [], []
    orig = det.fused_stage_step_train
    monkeypatch.setattr(det, "fused_stage_step_train", lambda *a, **k: (
        calls.append(a[1].shape), orig(*a, **k))[1])
    orig_pair = tl.MaxVitAttentionPair.forward
    monkeypatch.setattr(tl.MaxVitAttentionPair, "forward",
                        lambda self, *a, **k: (pairs.append(a[0].shape),
                                               orig_pair(self, *a, **k))[1])
    model = det.init_detector(cfg, device="cpu").train()
    T_, B_ = 2, 1
    ev = torch.from_numpy(np.random.RandomState(0).randint(
        0, 4, (T_, B_) + tuple(cfg.backbone.in_res_hw) + (20,))).float()
    feats, states = det.fused_train_scan_backbone(
        model, ev, zero_states(cfg.backbone, B_, device="cpu"),
        per_step=True)
    assert len(calls) == 3 * T_ and len(pairs) == T_
    assert all(tuple(p[1:]) == geo[0] for p in pairs)
    loss = sum(f.float().sum() for f in feats) + sum(
        h.sum() + c.sum() for h, c in states)
    loss.backward()
    assert len(pairs) == 2 * T_  # recomputed in the backward
    w = model.backbone.stages[0].att_blocks[0].att_grid.mlp.net[0][0].weight
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())
    assert float(w.grad.abs().sum()) > 0


def test_masked_per_step_backbone_matches_whole_window():
    """Token-masked training per step (stage 1 normed and masked in torch,
    its row-7 calls with ``ds_ln=False``) against the whole-window masked
    scan of the port: the forward bit for bit, every backbone gradient
    (the mask token's included) within GRAD_TOL."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import (fused_train_scan_backbone,
                                               init_detector)

    cfg = preset("gen1", "tiny", resolution_hw=(64, 80))
    cfg = replace(cfg.model, compute_dtype="bfloat16", backbone=replace(
        cfg.model.backbone, fused_kernels=True, enable_masking=True))
    model = init_detector(cfg, seed=3, device="cpu")
    Hi, Wi = cfg.backbone.in_res_hw
    rng = np.random.RandomState(4)
    ev = torch.from_numpy(rng.randint(0, 8, (T, B, Hi, Wi, 20))).float()
    tm = torch.from_numpy(rng.rand(T, B, Hi // 4, Wi // 4) < 0.25)
    states = zero_states(cfg.backbone, B, device="cpu")
    outs = []
    for per_step in (True, False):
        model.zero_grad(set_to_none=True)
        feats, final = fused_train_scan_backbone(
            model, ev, states, per_step=per_step, token_mask_seq=tm)
        o = list(feats) + [t for hc in final for t in hc]
        sum((x.float() * (i + 1)).sum() for i, x in enumerate(o)).backward()
        outs.append(([x.detach() for x in o],
                     {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}))
    (a, ga), (b, gb) = outs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert set(ga) == set(gb) and "backbone.stages.0.mask_token" in ga
    for n in ga:
        assert _rel(ga[n].numpy(), gb[n].numpy()) < GRAD_TOL, n
