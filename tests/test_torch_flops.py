"""The port's analytic FLOP count (``rvt_tpu_torch/utils/flops.py``, the
MFU numerator) against the partition shapes the JAX model really forms:
both attention blocks score and apply over ph * pw tokens per partition
(``rvt_tpu/models/layers.py:window_partition`` / ``grid_partition``)."""
import jax.numpy as jnp
import pytest

from rvt_tpu.models.layers import grid_partition, window_partition
from rvt_tpu_torch.config import preset
from rvt_tpu_torch.utils.flops import (_attention_pair,
                                       detector_flops_per_frame)

PRESETS = [(d, s) for d in ("gen1", "gen4") for s in ("tiny", "small",
                                                      "base")]


def _score_apply_flops(H, W, C, part, partition):
    """2 x (q k^T + p v) MACs of every partition of an H x W image."""
    parts, n, _ = partition(jnp.zeros((1, H, W, 1)), part).shape
    return 2 * 2 * parts * n * n * C


@pytest.mark.parametrize("dataset,size", PRESETS)
def test_attention_flops_follow_the_partitions(dataset, size):
    """Each stage's attention-pair count is the token-pointwise products
    plus the score/apply FLOPs of the window and the grid partitions."""
    m = preset(dataset, size).model
    bb = m.backbone
    part = tuple(bb.attention.partition_size)
    r = bb.attention.mlp_ratio
    Hi, Wi = bb.in_res_hw
    for s, C in zip(bb.strides, bb.stage_dims):
        H, W = Hi // s, Wi // s
        pointwise = 2 * (2 * H * W * C * C * (3 + 1 + 2 * r))
        attn = (_score_apply_flops(H, W, C, part, window_partition)
                + _score_apply_flops(H, W, C, part, grid_partition))
        assert _attention_pair(H, W, C, part, r) == pointwise + attn, (
            dataset, size, H, W, C)


@pytest.mark.parametrize("dataset,expected", [("gen1", 10.5176064e9),
                                              ("gen4", 31.25919744e9)])
def test_rvt_b_flops_per_frame(dataset, expected):
    """RVT-B per frame: the reference's count was 0.101 GFLOP short at gen1
    (10.417) and 0.708 GFLOP over at gen4 (31.967), from the grid block's
    (h / ph) * (w / pw) tokens per partition."""
    total = detector_flops_per_frame(preset(dataset, "base").model)["total"]
    assert total == pytest.approx(expected, rel=1e-9)
