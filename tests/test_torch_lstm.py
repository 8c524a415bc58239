"""The port's ConvLSTM scan (kernel K4's plain version, on the CPU) against
the JAX package's Pallas LSTM kernels in interpret mode."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import jax

from rvt_tpu.ops.fused_lstm import fused_conv_lstm as j_conv_lstm
from rvt_tpu.ops.fused_train import fused_lstm_scan_train as j_scan_train
from rvt_tpu.ops.fused_scan import fused_lstm_scan as j_lstm_scan
from rvt_tpu_torch.ops.fused_scan import (_lstm_cell_bwd, fused_conv_lstm,
                                          fused_lstm_scan, lstm_scan_plain)

T, B, H, W, C = 3, 2, 16, 20, 64


def _inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(T, B, H, W, C) * 0.5).astype(np.float32)
    lw = (rng.randn(2 * C, 4 * C) * 0.05).astype(np.float32)
    lb = (rng.randn(4 * C) * 0.05).astype(np.float32)
    h0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)  # nonzero carry
    c0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)
    return x, lw, lb, h0, c0


def test_lstm_scan_matches_jax():
    x, lw, lb, h0, c0 = _inputs()
    bf = jnp.bfloat16
    ref = j_lstm_scan(jnp.asarray(x, bf), jnp.asarray(lw, bf),
                      jnp.asarray(lb, bf).reshape(1, -1), jnp.asarray(h0),
                      jnp.asarray(c0), interpret=True)
    t = torch.from_numpy
    got = fused_lstm_scan(t(x).bfloat16(), t(lw).bfloat16(), t(lb).bfloat16(),
                          t(h0), t(c0))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (T, B, H, W, C)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(ref[0], np.float32), atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=4e-2)


def test_conv_lstm_matches_jax():
    """T = 1: the per-step cell of ops/fused_lstm.py, from f32 input."""
    x, lw, lb, h0, c0 = _inputs()
    bf = jnp.bfloat16
    hr, cr = j_conv_lstm(jnp.asarray(x[0]), jnp.asarray(h0), jnp.asarray(c0),
                         jnp.asarray(lw, bf),
                         jnp.asarray(lb, bf).reshape(1, -1), interpret=True)
    t = torch.from_numpy
    hg, cg = fused_conv_lstm(t(x[0]), t(h0), t(c0), t(lw).bfloat16(),
                             t(lb).bfloat16())
    np.testing.assert_allclose(hg.numpy(), np.asarray(hr), atol=2e-2)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cr), atol=4e-2)


def test_lstm_scan_plain_is_the_step_cell():
    """The plain scan equals T applications of the T = 1 cell."""
    x, lw, lb, h0, c0 = [torch.from_numpy(a) for a in _inputs()]
    w, b = lw.bfloat16(), lb.bfloat16()
    h_seq, hT, cT = lstm_scan_plain(x, w, b, h0, c0)
    h, c = h0, c0
    for step in range(T):
        h, c = fused_conv_lstm(x[step], h, c, w, b)
        assert torch.equal(h_seq[step], h.bfloat16())
    assert torch.equal(hT, h) and torch.equal(cT, c)


def _split_order_scan(x, w, b, h0, c0):
    """The cell in the summation order of the hoisted K4: x . W_x for every
    step in f32 first (one product over all T*B*H*W rows), then per step
    the f32 h . W_h added to it before the one bf16 rounding; b added
    after that rounding as in ``_lstm_cell``. Returns (h_seq, h_T, c_T)."""
    Cx = h0.shape[-1]
    wf = w.float()
    xw = x.to(torch.bfloat16).float() @ wf[:Cx]  # [T, B, H, W, 4C] f32
    h, c = h0.float(), c0.float()
    hs = []
    for t in range(x.shape[0]):
        mix = (xw[t] + h.to(torch.bfloat16).float() @ wf[Cx:]).to(
            torch.bfloat16)
        mix = (mix.float() + b.float()).to(torch.bfloat16).float()
        gates = torch.sigmoid(mix[..., :3 * Cx]).to(torch.bfloat16).float()
        f, i, o = gates.split(Cx, dim=-1)
        g = torch.tanh(mix[..., 3 * Cx:]).to(torch.bfloat16).float()
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h.to(torch.bfloat16))
    return torch.stack(hs), h, c


@pytest.mark.parametrize("width", [64, 96])
def test_lstm_scan_split_order_matches_jax(width):
    """The hoisted K4's order of the f32 sums (x . W_x and h . W_h apart,
    one bf16 rounding of their sum) against the TPU kernel's single 2C-deep
    dot, within test_lstm_scan_matches_jax's tolerance. The plain version
    keeps the single dot."""
    rng = np.random.RandomState(1)
    x = (rng.randn(T, B, H, W, width) * 0.5).astype(np.float32)
    lw = (rng.randn(2 * width, 4 * width) * 0.05).astype(np.float32)
    lb = (rng.randn(4 * width) * 0.05).astype(np.float32)
    h0 = (rng.randn(B, H, W, width) * 0.1).astype(np.float32)
    c0 = (rng.randn(B, H, W, width) * 0.1).astype(np.float32)
    bf = jnp.bfloat16
    ref = j_lstm_scan(jnp.asarray(x, bf), jnp.asarray(lw, bf),
                      jnp.asarray(lb, bf).reshape(1, -1), jnp.asarray(h0),
                      jnp.asarray(c0), interpret=True)
    t = torch.from_numpy
    got = _split_order_scan(t(x), t(lw).bfloat16(), t(lb).bfloat16(), t(h0),
                            t(c0))
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(ref[0], np.float32), atol=2e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=2e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=4e-2)


def _split_order_scan_bwd(x, w, b, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT,
                          CL):
    """BPTT in the summation order of the redesigned K8: the gates of every
    step from one product over all T*B*H*W rows (K2 "bias": one 2C-deep
    f32 dot, bf16, + b in bf16), then per step in reverse the carry
    dh_{t-1} as the CL blocks' f32 partials of bf16(dmix) . W_h^T, each
    over its own 4C/CL dmix columns (all four gates of C/CL channels),
    added in rank order; dx = bf16(dmix) . W_x^T after the loop over every
    step at once. Returns (dx, dW, db, dh0, dc0)."""
    T, Cx = x.shape[0], h0.shape[-1]
    Cs = Cx // CL
    wf = w.float()
    h_prev = torch.cat([h0.to(torch.bfloat16)[None], h_seq[:-1]]).float()
    c_prev = torch.cat([c0[None], c_seq[:-1]])
    xh = torch.cat([x.to(torch.bfloat16).float(), h_prev], -1)
    mix = (xh @ wf).to(torch.bfloat16)
    mix = (mix.float() + b.float()).to(torch.bfloat16).float()
    gates = torch.sigmoid(mix[..., :3 * Cx]).to(torch.bfloat16).float()
    f, i, o = gates.split(Cx, dim=-1)
    g = torch.tanh(mix[..., 3 * Cx:]).to(torch.bfloat16).float()
    c_t = f * c_prev + i * g
    cols = [torch.cat([torch.arange(q * Cx + r * Cs, q * Cx + (r + 1) * Cs)
                       for q in range(4)]) for r in range(CL)]
    dh, dc = dhT.float(), dcT.float()
    dmix = [None] * T
    for t in reversed(range(T)):
        dmix[t], dc = _lstm_cell_bwd(f[t], i[t], o[t], g[t], c_prev[t],
                                     c_t[t], dh + dh_seq[t].float(), dc)
        dmb = dmix[t].to(torch.bfloat16).float()
        dh = sum(dmb[..., cols[r]] @ wf[Cx:, cols[r]].t()
                 for r in range(CL))
    dmix = torch.stack(dmix)
    dmb = dmix.to(torch.bfloat16).float()
    dx = dmb @ wf[:Cx].t()
    dW = xh.reshape(-1, 2 * Cx).t() @ dmb.reshape(-1, 4 * Cx)
    return dx, dW, dmix.reshape(-1, 4 * Cx).sum(0), dh, dc


@pytest.mark.parametrize("width,CL", [(64, 1), (96, 2)])
def test_lstm_scan_bwd_split_order_matches_jax(width, CL):
    """The redesigned K8's order of the f32 sums (the gates from one
    product over all steps, dh through the W_h^T partials in rank order,
    dx apart after the loop) against the TPU kernel's per-step 4C-deep
    dot (``_lstm_scan_train_bwd`` in interpret mode), at
    test_torch_train_ops.py's gradient tolerance. The plain version keeps
    the single dot."""
    rng = np.random.RandomState(2)
    Tn, Bn, Hn, Wn = 3, 2, 8, 10
    x = (rng.randn(Tn, Bn, Hn, Wn, width) * 1.5).astype(np.float32)
    lw = (rng.randn(2 * width, 4 * width) * (2 * width) ** -0.5).astype(
        np.float32)
    lb = (rng.randn(4 * width) * 0.1).astype(np.float32)
    h0 = (rng.randn(Bn, Hn, Wn, width) * 0.3).astype(np.float32)
    c0 = (rng.randn(Bn, Hn, Wn, width) * 0.3).astype(np.float32)
    dh_seq = rng.randn(Tn, Bn, Hn, Wn, width).astype(np.float32)
    dhT = rng.randn(Bn, Hn, Wn, width).astype(np.float32)
    dcT = rng.randn(Bn, Hn, Wn, width).astype(np.float32)
    bf = jnp.bfloat16
    jw, jb = jnp.asarray(lw, bf), jnp.asarray(lb, bf).reshape(1, -1)
    out, vjp = jax.vjp(lambda *a: j_scan_train(True, *a), jnp.asarray(x), jw,
                       jb, jnp.asarray(h0), jnp.asarray(c0))
    ref = vjp((jnp.asarray(dh_seq, bf), jnp.asarray(dhT), jnp.asarray(dcT)))
    t = torch.from_numpy
    h_seq, c_seq, _, _ = lstm_scan_plain(t(x), t(lw).bfloat16(),
                                         t(lb).bfloat16(), t(h0), t(c0),
                                         with_c_seq=True)
    got = _split_order_scan_bwd(
        t(x), t(lw).bfloat16(), t(lb).bfloat16(), t(h0), t(c0), h_seq,
        c_seq, t(dh_seq).bfloat16(), t(dhT), t(dcT), CL)
    for name, gt, rf in zip(("dx", "dW", "db", "dh0", "dc0"), got, ref):
        rf = np.asarray(rf, np.float32)
        err = np.abs(gt.numpy().reshape(rf.shape) - rf).max()
        assert err <= 1.2e-2 * np.abs(rf).max(), (name, err)
