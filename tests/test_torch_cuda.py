"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Needs an NVIDIA GPU and nvcc; skips without a card.
On a machine with one: ``python -m pytest tests/test_torch_cuda.py -q``.
``chip_smoke.py`` makes the same checks at the gen1 RVT-B shapes."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, ref, atol=1e-2, rtol=1e-2):
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_rows_kernel(dev, dtype):
    from rvt_tpu_torch.ops import fused_attention as fa

    x = _randn(dev, 1000, 96, scale=2.0, dtype=dtype)
    s, b = _randn(dev, 96, seed=1) + 1, _randn(dev, 96, seed=2)
    n = fa.LN_ROWS.launches
    y, yf = fa.ln_rows(x, s, b, 1e-5, with_f32=True)
    assert fa.LN_ROWS.launches == n + 1
    _close(y, fa.ln_rows_plain(x, s, b, 1e-5))
    assert torch.equal(yf, y.float())


@pytest.mark.parametrize("epi", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("mkn", [(1000, 96, 40), (130, 256, 192)])
def test_gemm_kernel(dev, epi, mkn):
    from rvt_tpu_torch.ops import fused_attention as fa

    M, K, N = mkn
    a, w = _randn(dev, M, K), _randn(dev, K, N, scale=K ** -0.5, seed=1)
    bias = _randn(dev, N, scale=0.1, seed=2)
    R = _randn(dev, M, N, dtype=torch.float32, seed=3)
    res = (lambda: R.clone()) if epi == "residual" else (lambda: None)
    _close(fa.gemm_bf16(a, w, bias, epi, res()),
           fa.gemm_bf16_plain(a, w, bias, epi, res()))


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("geom", [(16, 20, 64, 32, (8, 10)),
                                  (12, 12, 32, 16, (2, 3))])
def test_partition_attention_kernel(dev, window, geom):
    from rvt_tpu_torch.ops import fused_attention as fa

    H, W, C, dh, part = geom
    qkv = _randn(dev, 3, H, W, 3 * C)
    got = fa.partition_attention(qkv, heads=C // dh, dim_head=dh, part=part,
                                 window=window)
    _close(got, fa.partition_attention_plain(qkv, C // dh, dh, part, window))


@pytest.mark.parametrize("C", [32, 128, 256])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_lstm_scan_kernel(dev, C, xdtype):
    from rvt_tpu_torch.ops import fused_scan as fs

    T, B, H, W = 4, 2, 5, 7  # 35 pixels: a ragged last tile of 16
    x = _randn(dev, T, B, H, W, C, dtype=xdtype)
    w = _randn(dev, 2 * C, 4 * C, scale=(2 * C) ** -0.5, seed=1)
    b = _randn(dev, 4 * C, scale=0.1, seed=2)
    h0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=3)
    c0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=4)
    got = fs.fused_lstm_scan(x, w, b, h0, c0)
    ref = fs.lstm_scan_plain(x, w, b, h0, c0)
    for g, r in zip(got, ref):
        _close(g, r, atol=2e-2, rtol=2e-2)



@pytest.mark.parametrize("case", ["uniform", "clustered", "dropped",
                                  "bin_edges"])
def test_stacked_histogram_kernel(dev, case):
    """Integer counts: the kernel equals its plain version exactly,
    whatever order its atomics ran in."""
    from rvt_tpu_torch.ops import voxelization as vx

    B, N, bins, H, W = 3, 5000, 10, 30, 37  # 3*2*10*30*37 % 16 = 8: tail
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(lo, hi):
        return torch.randint(lo, hi, (B, N), generator=g, device=dev,
                             dtype=torch.int32)

    x, y, p = ints(0, W), ints(0, H), ints(0, 2)
    t = torch.sort(ints(0, 50_000), dim=1).values
    counts = torch.tensor([N, N - 17, 0], dtype=torch.int32, device=dev)
    if case == "clustered":
        x[0], y[0] = 7, 11
    elif case == "dropped":
        x[1, ::7], y[1, 1::7], p[1, 2::7] = W, -1, 2
        x[0, ::5] = -3
    elif case == "bin_edges":  # spans where inexact f32 math moves a bin
        spans = torch.tensor([25, 50, 100], device=dev)
        t = (torch.minimum(torch.arange(N, device=dev)[None], spans[:, None])
             + 1000).to(torch.int32)
        counts = (spans + 1).to(torch.int32)
    n = vx.STACKED_HISTOGRAM.launches
    got = vx.stacked_histogram_batched(x, y, p, t, counts, bins, H, W)
    assert vx.STACKED_HISTOGRAM.launches == n + 1
    ref = vx.stacked_histogram_plain(x, y, p, t, counts, bins, H, W)
    assert got.dtype == torch.uint8 and torch.equal(got, ref)
    if case == "clustered":
        assert int(got[0].max()) == 255
