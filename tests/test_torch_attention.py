"""The port's attention pair and stage scan (rvt_tpu_torch, plain PyTorch
versions on the CPU) against the JAX package's Pallas kernels run in
interpret mode. Inputs and weights are made once with numpy / flax and
handed to both; the weights reach the port through the weight bridge."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.config import AttentionConfig
from rvt_tpu.models.layers import MaxVitAttentionPair
from rvt_tpu.ops import fused_attention as jfa
from rvt_tpu.ops import fused_scan as jfs
from rvt_tpu_torch.config import AttentionConfig as TAttentionConfig
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.models.layers import MaxVitAttentionPair as TPair
from rvt_tpu_torch.ops import fused_attention as tfa
from rvt_tpu_torch.ops import fused_scan as tfs

GEN1 = (16, 20, 64, 32, (8, 10))  # H, W, C, dim_head, partition
# gen4's partition (60 tokens) at the small presets' dim_head 24
GEN4_SMALL = (12, 20, 48, 24, (6, 10))
H, W, C, DH, PART = GEN1


def _pair_weights(sfn: bool, geom=GEN1):
    """flax pair variables (perturbed off their identity-ish init, as
    tests/test_fused_attention.py does) and the same weights in the
    port's pair module."""
    H, W, C, DH, PART = geom
    cfg = AttentionConfig(partition_size=PART, dim_head=DH)
    mod = MaxVitAttentionPair(dim=C, cfg=cfg, skip_first_norm=sfn,
                              dtype=jnp.bfloat16, fused=False)
    x = jnp.zeros((1, H, W, C), jnp.bfloat16)
    variables = mod.init(jax.random.PRNGKey(1), x)
    variables = jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(
            np.random.RandomState(3).randn(*a.shape), a.dtype), variables)
    sd = from_flax({"params": {"backbone": {"stage1": {
        "block0": variables["params"]}}}})
    pair = TPair(C, TAttentionConfig(partition_size=PART, dim_head=DH), sfn)
    pair.load_state_dict({k.split("att_blocks.0.", 1)[1]: v
                          for k, v in sd.items()}, strict=True)
    return variables["params"], pair


def _ln_params(rng, C=C):
    s = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    return s, b


@pytest.mark.parametrize(
    "sfn,ds_ln,geom", [(True, False, GEN1), (False, False, GEN1),
                       (True, True, GEN1), (True, True, GEN4_SMALL)],
    ids=["skip_first_norm", "norm1", "ds_ln", "part6x10_dh24"])
def test_attention_pair_matches_jax(sfn, ds_ln, geom):
    H, W, C, DH, PART = geom
    p, pair = _pair_weights(sfn, geom)
    rng = np.random.RandomState(0)
    x = (rng.randn(2, H, W, C) * (2.0 if ds_ln else 1.0)).astype(np.float32)
    s, b = _ln_params(rng, C)
    jds = ((jnp.asarray(s, jnp.bfloat16).reshape(1, -1),
            jnp.asarray(b, jnp.bfloat16).reshape(1, -1)) if ds_ln else ())
    tds = ((torch.from_numpy(s).bfloat16(), torch.from_numpy(b).bfloat16())
           if ds_ln else ())
    ref = jfa.fused_attention_pair(
        jnp.asarray(x, jnp.bfloat16),
        jfa.attention_block_params(p["att_window"], sfn),
        jfa.attention_block_params(p["att_grid"], False), heads=C // DH,
        dim_head=DH, part=PART, skip_first_norm=sfn, eps=1e-5,
        ds_ln_params=jds, interpret=True)
    got = tfa.fused_attention_pair(
        torch.from_numpy(x).bfloat16(),
        tfa.attention_block_params(pair.att_window, sfn),
        tfa.attention_block_params(pair.att_grid, False), heads=C // DH,
        dim_head=DH, part=PART, skip_first_norm=sfn, eps=1e-5,
        ds_ln_params=tds)
    ref = np.asarray(ref, np.float32)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    # bf16-rounding-order differences only (as test_fused_attention.py)
    np.testing.assert_allclose(got, ref, atol=3e-2, rtol=3e-2)
    assert np.abs(got - ref).mean() < 3e-3


def test_stage_scan_matches_jax():
    """fused_stage_scan (raw downsample-conv output in, ds-LN first): the
    port's pair-over-T*B + LSTM-scan composition against the TPU's
    one-kernel stage scan."""
    T, B = 3, 2
    p, pair = _pair_weights(True)
    rng = np.random.RandomState(0)
    x = (rng.randn(T, B, H, W, C) * 2.0).astype(np.float32)
    lw = (rng.randn(2 * C, 4 * C) * 0.05).astype(np.float32)
    lb = (rng.randn(4 * C) * 0.05).astype(np.float32)
    h0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)
    c0 = (rng.randn(B, H, W, C) * 0.1).astype(np.float32)
    s, b = _ln_params(rng)
    bf = jnp.bfloat16
    ref = jfs.fused_stage_scan(
        jnp.asarray(x, bf), jfa.attention_block_params(p["att_window"], True),
        jfa.attention_block_params(p["att_grid"], False),
        jnp.asarray(lw, bf), jnp.asarray(lb, bf).reshape(1, -1),
        jnp.asarray(h0), jnp.asarray(c0), heads=C // DH, dim_head=DH,
        part=PART, eps=1e-5,
        ds_ln_params=(jnp.asarray(s, bf).reshape(1, -1),
                      jnp.asarray(b, bf).reshape(1, -1)), interpret=True)
    t = torch.from_numpy
    got = tfs.fused_stage_scan(
        t(x).bfloat16(), tfa.attention_block_params(pair.att_window, True),
        tfa.attention_block_params(pair.att_grid, False), t(lw).bfloat16(),
        t(lb).bfloat16(), t(h0), t(c0), heads=C // DH, dim_head=DH,
        part=PART, eps=1e-5,
        ds_ln_params=(t(s).bfloat16(), t(b).bfloat16()))
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(ref[0], np.float32), atol=4e-2)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=4e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=8e-2)
