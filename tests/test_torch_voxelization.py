"""The port's voxelizer (the plain PyTorch version of the CUDA kernel
``stacked_histogram``, on the CPU) against the JAX package's voxelizers:
the XLA scatter on in-range events, and the Pallas kernel in interpret
mode on the clustered, multi-tile and out-of-range cases of
``tests/test_ops.py``. Histograms are integers: every comparison is
exact."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.ops.voxelization import (_time_bin_indices as j_time_bins,
                                      stacked_histogram,
                                      stacked_histogram_pallas_batched)
from rvt_tpu_torch.inference import ds2_retarget, nearest_downsample2
from rvt_tpu_torch.ops.voxelization import (_time_bin_indices,
                                            stacked_histogram_batched)


def _events(rng, B, N, H, W, counts):
    x = rng.randint(0, W, (B, N)).astype(np.int32)
    y = rng.randint(0, H, (B, N)).astype(np.int32)
    p = rng.randint(0, 2, (B, N)).astype(np.int32)
    t = np.sort(rng.randint(0, 50_000, (B, N)), axis=1).astype(np.int32)
    return x, y, p, t, np.asarray(counts, np.int32)


def _port(ev, bins, H, W):
    return stacked_histogram_batched(*(torch.from_numpy(a) for a in ev),
                                     bins, H, W).numpy()


def _pallas(ev, bins, H, W, chunk=1024):
    return np.asarray(stacked_histogram_pallas_batched(
        *(jnp.asarray(a) for a in ev), bins=bins, height=H, width=W,
        chunk=chunk, interpret=True))


def _xla(ev, bins, H, W):
    return np.asarray(jax.vmap(
        lambda xi, yi, pi, ti, n: stacked_histogram(xi, yi, pi, ti, n, bins,
                                                    H, W))(
        *(jnp.asarray(a) for a in ev)))


@pytest.mark.parametrize("counts", [[3000, 4096], [0, 1]],
                         ids=["prefix", "empty"])
def test_plain_matches_xla_scatter_in_range(counts):
    ev = _events(np.random.RandomState(2), 2, 4096, 16, 24, counts)
    got = _port(ev, 4, 16, 24)
    assert got.dtype == np.uint8 and got.shape == (2, 8, 16, 24)
    np.testing.assert_array_equal(got, _xla(ev, 4, 16, 24))


def test_time_bins_bit_exact_at_bin_edges():
    """Every timestamp of spans where a reciprocal multiply or a fused
    multiply-add in place of the f32 division and product would move an
    event to the next bin (25 and 50: the division; 10, 50 and 100: the
    contraction), and both sides of every bin edge of a long span."""
    bins, N = 10, 101
    lanes, counts = [], []
    for span in (10, 25, 50, 100):
        lanes.append(np.minimum(np.arange(N), span))
        counts.append(span + 1)
    long_span = 1_234_567
    edges = (np.arange(bins + 1)[:, None] * long_span // bins
             + np.array([-1, 0, 1])[None]).ravel()
    lanes.append(np.sort(np.clip(np.resize(edges, N), 0, long_span)))
    counts.append(N - 5)
    t = np.stack(lanes).astype(np.int32) + 1_000
    counts = np.asarray(counts, np.int32)
    ref = np.stack([np.asarray(j_time_bins(jnp.asarray(tb), jnp.asarray(n),
                                           bins))
                    for tb, n in zip(t, counts)])
    got = _time_bin_indices(torch.from_numpy(t), torch.from_numpy(counts),
                            bins).numpy()
    np.testing.assert_array_equal(got, ref)


def test_plain_matches_pallas_single_lane():
    """tests/test_ops.py: one lane with a valid prefix, chunked events."""
    ev = _events(np.random.RandomState(2), 1, 4096, 16, 24, [3000])
    np.testing.assert_array_equal(_port(ev, 4, 16, 24),
                                  _pallas(ev, 4, 16, 24))


def test_plain_matches_pallas_multitile_clustered():
    """Three row tiles; lane 0 has every event on one pixel (2048 events
    saturate at 255), lane 1 a short valid prefix."""
    rng = np.random.RandomState(7)
    H, W, bins = 96, 24, 2
    x, y, p, t, counts = _events(rng, 2, 2048, H, W, [2048, 801])
    x[0], y[0] = 5, 17
    ev = (x, y, p, t, counts)
    got = _port(ev, bins, H, W)
    assert got.max() == 255
    np.testing.assert_array_equal(got, _pallas(ev, bins, H, W))


def test_plain_matches_pallas_out_of_range():
    """Out-of-range x, y and p inside the valid prefix are dropped, not
    row-aliased (the Pallas kernel's contract)."""
    rng = np.random.RandomState(11)
    H, W, bins, n = 16, 24, 4, 300
    x, y, p, t, counts = _events(rng, 1, 512, H, W, [n])
    bad = rng.choice(n, 40, replace=False)
    x[0, bad[:10]] = W + rng.randint(0, 5, 10)
    x[0, bad[10:15]] = -1
    y[0, bad[15:25]] = H + rng.randint(0, 3, 10)
    y[0, bad[25:30]] = -2
    p[0, bad[30:]] = 2
    ev = (x, y, p, t, counts)
    got = _port(ev, bins, H, W)
    np.testing.assert_array_equal(got, _pallas(ev, bins, H, W, chunk=512))
    ok = np.ones(512, bool)
    ok[bad] = False
    assert got.sum() == ok[:n].sum()


def test_ds2_retarget_equals_full_resolution_then_downsample():
    """gen4's ds2-direct voxelize (odd-coordinate events into the half
    grid) equals voxelizing the full sensor and taking [..., 1::2, 1::2],
    in the port and against the JAX Pallas voxelizer; negative and
    overflowing coordinates included, where C's truncating % and / would
    differ from the floor-mod the retarget uses."""
    rng = np.random.RandomState(3)
    bins, H, W = 4, 24, 32
    x, y, p, t, counts = _events(rng, 2, 2048, H, W, [1800, 900])
    x[0, :40] = rng.randint(-5, 0, 40)
    y[1, :40] = rng.randint(H, H + 5, 40)
    ev = (x, y, p, t, counts)
    full = _pallas(ev, bins, H, W)[..., 1::2, 1::2]
    np.testing.assert_array_equal(
        nearest_downsample2(torch.from_numpy(_port(ev, bins, H, W))).numpy(),
        full)
    vH, vW = H // 2, W // 2
    x2, y2 = ds2_retarget(torch.from_numpy(x), torch.from_numpy(y), bins,
                          vH, vW)
    # the JAX package's retarget, as in rvt_tpu/inference.py
    odd = (x % 2 == 1) & (y % 2 == 1)
    np.testing.assert_array_equal(
        x2.numpy(), np.where(odd, x // 2, 2 * bins * vH * vW))
    np.testing.assert_array_equal(y2.numpy(), np.where(odd, y // 2, vH))
    np.testing.assert_array_equal(
        _port((x2.numpy(), y2.numpy(), p, t, counts), bins, vH, vW), full)
