"""The port's train-layout stage (rvt_tpu_torch.ops.fused_train, plain
PyTorch versions of the kernels on the CPU) against the JAX package's
``fused_pair_train`` / ``fused_lstm_scan_train`` in interpret mode, forward
and every gradient, at (16, 10, 32), partition (8, 10), dh 32, and at a
small-preset stage (12, 20, 96), partition (6, 10), dh 24 (RVT-S stage 2,
gen4's partition); and the train-mode BatchNorm against flax's."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.ops import fused_train as jft
from rvt_tpu_torch.ops import fused_train as tft

# (H, W, C, partition, dh)
TINY = (16, 10, 32, (8, 10), 32)
SMALL = (12, 20, 96, (6, 10), 24)
T, B = 3, 2
EPS = 1e-5

# Tolerances, relative to max |ref| of each tensor. Both sides run the same
# arithmetic with the same bf16 rounding points; they differ in the order
# of f32 sums (XLA's dot and reductions vs PyTorch's), which moves a bf16
# rounding (of dS, dmix, the products' outputs) by one ulp now and then:
# the largest seen is 0.006 (1.5 bf16 ulps). The JAX suite holds its
# fused kernels against its XLA path at 6e-2 / 8e-2.
FWD_TOL = 5e-3
GRAD_TOL = 1.2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(rng, sfn, C=TINY[2]):
    """One sub-block in the train layout (``train_block_params``), as
    float32 numpy arrays of bf16-exact weights, and the dtype of each."""
    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    leaves = []
    if not sfn:
        leaves += [(bf(1 + 0.2 * rng.randn(C)), "bf16"),
                   (bf(0.2 * rng.randn(C)), "bf16")]
    leaves += [(bf(rng.randn(C, 3 * C) * C ** -0.5), "bf16"),
               (bf(0.1 * rng.randn(3 * C)), "bf16"),
               (bf(rng.randn(C, C) * C ** -0.5), "bf16"),
               (bf(0.1 * rng.randn(C)), "bf16"),
               ((0.3 + 0.1 * rng.randn(C)).astype(np.float32), "f32"),
               (bf(1 + 0.2 * rng.randn(C)), "bf16"),
               (bf(0.2 * rng.randn(C)), "bf16"),
               (bf(rng.randn(C, 4 * C) * C ** -0.5), "bf16"),
               (bf(0.1 * rng.randn(4 * C)), "bf16"),
               (bf(rng.randn(4 * C, C) * (4 * C) ** -0.5), "bf16"),
               (bf(0.1 * rng.randn(C)), "bf16"),
               ((0.3 + 0.1 * rng.randn(C)).astype(np.float32), "f32")]
    return leaves


def _jax(a, kind):
    dt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    return jnp.asarray(a if a.ndim > 1 else a.reshape(1, -1), dt)


def _torch(a, kind):
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return torch.from_numpy(a).to(dt).requires_grad_(True)


def _rel(got, ref):
    got = np.asarray(got, np.float32).reshape(np.shape(ref))
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _pair_case(geom):
    H, W, C, PART, DH = geom
    rng = np.random.RandomState(0)
    N = T * B
    x = np.asarray(jnp.asarray(rng.randn(N, H, W, C) * 2 + 0.3,
                               jnp.bfloat16), np.float32)
    ds = [(np.asarray(jnp.asarray(1 + 0.2 * rng.randn(C), jnp.bfloat16),
                      np.float32), "bf16"),
          (np.asarray(jnp.asarray(0.2 * rng.randn(C), jnp.bfloat16),
                      np.float32), "bf16")]
    win, grid = _block(rng, True, C), _block(rng, False, C)
    wgt = rng.randn(N, H, W, C).astype(np.float32)

    cfg = (C // DH, DH, PART, EPS, EPS, False, True)

    def jloss(x, ds_s, ds_b, win, grid):
        y = jft.fused_pair_train(cfg, x, ds_s, ds_b, tuple(win), tuple(grid))
        return jnp.sum(y * wgt), y

    jargs = (jnp.asarray(x, jnp.bfloat16), _jax(*ds[0]), _jax(*ds[1]),
             [_jax(*l) for l in win], [_jax(*l) for l in grid])
    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(*jargs)

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tds = [_torch(*l) for l in ds]
    twin = [_torch(*l) for l in win]
    tgrid = [_torch(*l) for l in grid]
    cfg_t = tft.StageCfg(C // DH, DH, PART, EPS, EPS)
    ty = tft.FusedPairTrain.apply(cfg_t, tx, *tds, *twin, *tgrid)
    (ty * torch.from_numpy(wgt)).sum().backward()
    return jy, jg, ty, tx, tds, twin, tgrid


@pytest.fixture(scope="module")
def pair_case():
    return _pair_case(TINY)


@pytest.fixture(scope="module")
def pair_case_small():
    return _pair_case(SMALL)


def _check_pair_forward(case):
    jy, _, ty, *_ = case
    assert ty.dtype == torch.float32
    assert _rel(ty.detach().numpy(), jy) < FWD_TOL


def test_pair_forward_matches_jax(pair_case):
    _check_pair_forward(pair_case)


def test_pair_forward_matches_jax_small_preset(pair_case_small):
    _check_pair_forward(pair_case_small)


def test_pair_grads_match_jax(pair_case):
    _check_pair_grads(pair_case)


def test_pair_grads_match_jax_small_preset(pair_case_small):
    _check_pair_grads(pair_case_small)


def _check_pair_grads(case):
    _, jg, _, tx, tds, twin, tgrid = case
    jx, jds_s, jds_b, jwin, jgrid = jg
    pairs = ([("x", tx, jx), ("ds_s", tds[0], jds_s),
              ("ds_b", tds[1], jds_b)]
             + [(f"win{i}", t, j) for i, (t, j) in enumerate(zip(twin, jwin))]
             + [(f"grid{i}", t, j)
                for i, (t, j) in enumerate(zip(tgrid, jgrid))])
    for name, t, j in pairs:
        # gradients leave in their parameter's dtype, as the JAX VJP's do
        assert t.grad.dtype == t.dtype, name
        assert str(j.dtype) == {torch.bfloat16: "bfloat16",
                                torch.float32: "float32"}[t.dtype], name
        err = _rel(t.grad.float().numpy(), j)
        assert err < GRAD_TOL, (name, err)


def _lstm_case(geom):
    H, W, C = geom[:3]
    rng = np.random.RandomState(1)
    x = (rng.randn(T, B, H, W, C) * 1.5).astype(np.float32)
    w = np.asarray(jnp.asarray(rng.randn(2 * C, 4 * C) * (2 * C) ** -0.5,
                               jnp.bfloat16), np.float32)
    b = np.asarray(jnp.asarray(0.1 * rng.randn(4 * C), jnp.bfloat16),
                   np.float32)
    h0 = (rng.randn(B, H, W, C) * 0.3).astype(np.float32)
    c0 = (rng.randn(B, H, W, C) * 0.3).astype(np.float32)
    wh = rng.randn(T, B, H, W, C).astype(np.float32)
    wT = rng.randn(B, H, W, C).astype(np.float32)

    def total(h_seq, hT, cT, lib):
        if lib is jnp:
            hs = h_seq.astype(jnp.float32)
        else:
            hs = h_seq.float()
            wh_, wT_ = torch.from_numpy(wh), torch.from_numpy(wT)
            return ((hs * wh_).sum() + (hT * wT_).sum()
                    + 0.5 * (torch.tanh(cT) * wT_).sum())
        return (jnp.sum(hs * wh) + jnp.sum(hT * wT)
                + 0.5 * jnp.sum(jnp.tanh(cT) * wT))

    def jloss(x, w, b, h0, c0):
        out = jft.fused_lstm_scan_train(True, x, w, b, h0, c0)
        return total(*out, jnp), out

    jargs = (jnp.asarray(x), jnp.asarray(w, jnp.bfloat16),
             jnp.asarray(b.reshape(1, -1), jnp.bfloat16), jnp.asarray(h0),
             jnp.asarray(c0))
    (_, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(5)),
                                       has_aux=True)(*jargs)
    targs = [torch.from_numpy(x).requires_grad_(True),
             torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True),
             torch.from_numpy(b).to(torch.bfloat16).requires_grad_(True),
             torch.from_numpy(h0).requires_grad_(True),
             torch.from_numpy(c0).requires_grad_(True)]
    tout = tft.FusedLstmScanTrain.apply(False, *targs)
    total(*tout, torch).backward()
    return jout, jg, tout, targs


@pytest.fixture(scope="module")
def lstm_case():
    return _lstm_case(TINY)


@pytest.fixture(scope="module")
def lstm_case_small():
    return _lstm_case(SMALL)


def _check_lstm_forward(case):
    jout, _, tout, _ = case
    assert tout[0].dtype == torch.bfloat16
    for name, t, j in zip(("h_seq", "h_T", "c_T"), tout, jout):
        assert _rel(t.detach().float().numpy(), j) < FWD_TOL, name


def test_lstm_scan_forward_matches_jax(lstm_case):
    _check_lstm_forward(lstm_case)


def test_lstm_scan_forward_matches_jax_small_preset(lstm_case_small):
    _check_lstm_forward(lstm_case_small)


def test_lstm_scan_grads_match_jax(lstm_case):
    _check_lstm_grads(lstm_case)


def test_lstm_scan_grads_match_jax_small_preset(lstm_case_small):
    _check_lstm_grads(lstm_case_small)


def _check_lstm_grads(case):
    _, jg, _, targs = case
    for name, t, j in zip(("x", "w", "b", "h0", "c0"), targs, jg):
        assert t.grad.dtype == t.dtype, name
        err = _rel(t.grad.float().numpy(), j)
        assert err < GRAD_TOL, (name, err)


# (act, conv dtype, a constant output channel): every activation on both
# conv dtypes, and silu with channel 0's kernel zeroed, so that y's channel
# is 0 everywhere and E[y^2] - E[y]^2 is 0 (the clamp's edge: the
# variance's gradient must vanish, not turn NaN)
_BN_CASES = [(a, d, False) for d in ("bf16", "f32")
             for a in ("silu", "relu", "lrelu")] + [("silu", "bf16", True)]


@pytest.mark.parametrize(
    "act,dtype,const", _BN_CASES,
    ids=[f"{a}-{d}" + ("-const" if c else "") for a, d, c in _BN_CASES])
def test_batch_norm_train_mode_matches_flax(act, dtype, const):
    """A train-mode BaseConv (bf16 or f32 conv, flax BatchNorm on batch
    statistics, then the activation) through ``ops/bn_act.py``'s plain
    two-pass version: output, updated running buffers (biased variance,
    momentum 0.9) and the gradients of x, the conv kernel, scale and bias
    against flax's."""
    from rvt_tpu.models.yolox import BaseConv as JBaseConv
    from rvt_tpu_torch.models.yolox import BaseConv
    from rvt_tpu_torch.ops import bn_act

    bf16 = dtype == "bf16"
    rng = np.random.RandomState(4)
    x = rng.randn(4, 6, 8, 16).astype(np.float32)
    jm = JBaseConv(features=24, ksize=3, stride=1, act=act,
                   dtype=jnp.bfloat16 if bf16 else None)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(rng.randn(*a.shape), a.dtype), v)
    if const:
        v["params"]["conv"]["kernel"] = v["params"]["conv"]["kernel"].at[
            ..., 0].set(0.0)
    wgt = rng.randn(4, 6, 8, 24).astype(np.float32)

    def jloss(params, xx):
        y, mut = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          xx, True, mutable=["batch_stats"])
        return jnp.sum(y * wgt), (y, mut)

    (_, (jy, mut)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tm = BaseConv(16, 24, 3, 1, act=act)
    p, bs = v["params"], v["batch_stats"]
    with torch.no_grad():
        tm.conv.weight.copy_(torch.from_numpy(
            np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        tm.bn.weight.copy_(torch.from_numpy(np.array(p["bn"]["scale"])))
        tm.bn.bias.copy_(torch.from_numpy(np.array(p["bn"]["bias"])))
        tm.bn.running_mean.copy_(torch.from_numpy(
            np.array(bs["bn"]["mean"])))
        tm.bn.running_var.copy_(torch.from_numpy(np.array(bs["bn"]["var"])))
    tm.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    n = bn_act.BN_ACT.launches
    y = tm(tx, torch.bfloat16 if bf16 else torch.float32)
    (y.permute(0, 2, 3, 1) * torch.from_numpy(wgt)).sum().backward()
    assert bn_act.BN_ACT.launches == n  # the CPU takes the plain version
    # f32 statistics and affine on identical conv outputs: f32 noise
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["bn"]["var"]),
                               rtol=1e-5)
    for got, ref in ((tm.bn.weight.grad, jg["bn"]["scale"]),
                     (tm.bn.bias.grad, jg["bn"]["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)
    if const:  # no gradient through the clamped variance: scale's is 0
        assert float(tm.bn.weight.grad[0]) == 0.0
        assert np.isfinite(tx.grad.numpy()).all()
    # the conv's gradients are bf16 products on both sides (one ulp); in
    # f32 the sums' order alone
    tol = 2 ** -7 if bf16 else 1e-5
    for got, ref in ((tm.conv.weight.grad.numpy().transpose(2, 3, 1, 0),
                      np.asarray(jg["conv"]["kernel"])),
                     (tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgx))):
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max()
