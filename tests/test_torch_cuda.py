"""The port on the card, at small shapes: each CUDA kernel against its
plain PyTorch version, the eval, raw and train steps on the kernels
against the same steps on the plain versions, the captured steps against
the same steps eager, the per-step train backbone, the validation loop
and the module path against the CPU, and one data-parallel rank over
NCCL. Needs an NVIDIA GPU and nvcc; skips without a card. It imports
nothing of JAX. On a machine with one: ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``. ``chip_smoke.py`` times the kernels at
the gen1 RVT-B shapes; the benchmark (``benchmark/run.py``) times the
paths and holds them against its reference."""
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


# gen1 RVT-B's four stages (H, W, C) with M cut to two frames, at the
# C -> 4C and 4C -> C products; the per-step path's small M (8 frames of
# stage 4: the one-warpgroup tiles); ragged M, K and N (TMA's zero fill,
# the masked stores), the last on the three-warpgroup tiles. Each (M, K,
# N).
_STAGES = ((64, 80, 64), (32, 40, 128), (16, 20, 256), (8, 10, 512))
_GEMM_SHAPES = ([(1000, 96, 40), (130, 256, 192)]
                + [(2 * H * W, K, N) for H, W, C in _STAGES
                   for K, N in ((C, 4 * C), (4 * C, C))]
                + [(640, 512, 1536), (640, 2048, 512)]
                + [(1, 8, 40), (127, 40, 48), (129, 48, 8), (1000, 48, 40),
                   (17000, 64, 128)])


@pytest.mark.parametrize("epi", ["bias", "gelu", "residual"])
@pytest.mark.parametrize("mkn", _GEMM_SHAPES)
def test_gemm_kernel(dev, epi, mkn):
    from rvt_tpu_torch.ops import fused_attention as fa

    M, K, N = mkn
    a, w = _randn(dev, M, K), _randn(dev, K, N, scale=K ** -0.5, seed=1)
    bias = _randn(dev, N, scale=0.1, seed=2)
    R = _randn(dev, M, N, dtype=torch.float32, seed=3)
    res = (lambda: R.clone()) if epi == "residual" else (lambda: None)
    n = fa.GEMM_BF16.launches
    got = fa.gemm_bf16(a, w, epi, bias=bias, out=res())
    assert fa.GEMM_BF16.launches == n + 1
    ref = fa.gemm_bf16(a, w, epi, bias=bias, out=res(), plain=True)
    if epi == "residual":  # the bf16 increment: its ulp is |v|'s, not |R+v|'s
        out, copy = fa.gemm_bf16(a, w, epi, bias=bias, out=res(),
                                 want_aux=True)
        assert torch.equal(out, got) and torch.equal(
            copy, got.to(torch.bfloat16))
        got, ref = got - R, ref - R
    _close(got, ref)


def _pingpong_cases(sms):
    """(M, K, N) that take K2's ping-pong schedule (for its f32 epilogues)
    on a card of ``sms`` SMs: three 64-row tiles a block, so one consumer
    warpgroup runs two and the other one, the last M tile ragged (47
    rows); five tiles a block at N = 128 with K = 512 (eight k-tiles,
    more than the ring holds); and two 128-column tiles a row at a ragged
    K = 40, about three tiles a block, the last M tile ragged."""
    return [(3 * 64 * sms - 17, 64, 64), (5 * 64 * sms - 40, 512, 128),
            (64 * (3 * sms + 1) // 2 - 9, 40, 256)]


_EPILOGUES = ["bias", "gelu", "residual", "residual_ls", "rt_f32",
              "rt_bf16", "rt_acc", "rt_gelu_bwd"]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("epi", _EPILOGUES)
def test_gemm_pingpong_shapes(dev, monkeypatch, epi, case):
    """K2 at shapes where its f32 epilogues take the ping-pong schedule
    (uneven tiles per consumer warpgroup, ragged M, K and N), every
    epilogue: against the plain version at test_gemm_kernel's tolerances,
    the launcher's plan equal to ``gemm_schedule``, two runs bit for bit,
    and a 64-aligned window of rows run on its own (a small launch: the
    cooperative schedule) equal bit for bit to the same rows of the whole
    launch, the gelu backward's per-64-row column-sum partials too."""
    from rvt_tpu_torch.ops import fused_attention as fa

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    M, K, N = _pingpong_cases(sms)[case]
    rt = epi.startswith("rt_")
    plan = fa.gemm_plan(M, N, K, epi)
    assert plan == fa.gemm_schedule(M, N, K, epi, sms)
    assert plan.pingpong == (epi in ("residual", "residual_ls", "rt_f32",
                                     "rt_acc") or (case != 1 and epi in (
                                         "bias", "rt_bf16")))
    a = _randn(dev, M, K)
    w = _randn(dev, *((N, K) if rt else (K, N)), scale=K ** -0.5, seed=1)
    kw = {} if rt else dict(bias=_randn(dev, N, scale=0.1, seed=2))
    if epi == "residual_ls":
        kw.update(gamma=_randn(dev, N, scale=0.3, dtype=torch.float32,
                               seed=4),
                  res_in=_randn(dev, M, N, dtype=torch.float32, seed=3))
    if epi == "rt_gelu_bwd":
        kw["aux"] = _randn(dev, M, N, seed=5)
    R = _randn(dev, M, N, dtype=torch.float32, seed=3)
    inplace = epi in ("residual", "rt_acc")
    # the raw partials of the column sums, not their in-order sum
    monkeypatch.setattr(fa, "sum_parts", lambda part, **_: part)

    def run(rows=slice(None), plain=False):
        args = {k: (v[rows] if k in ("res_in", "aux") else v)
                for k, v in kw.items()}
        if inplace:
            args["out"] = R[rows].clone()
        return fa.gemm_bf16(a[rows], w, epi, plain=plain, **args)

    def first(x):
        return x[0] if isinstance(x, tuple) else x

    got, again = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(
        got if isinstance(got, tuple) else (got,),
        again if isinstance(again, tuple) else (again,)))
    ref = run(plain=True)
    g, r = first(got), first(ref)
    if epi in ("residual", "rt_acc"):  # the increment
        g, r = g - R, r - R
    elif epi == "residual_ls":
        g, r = g - kw["res_in"], r - kw["res_in"]
    _close(g, r)
    if epi == "rt_gelu_bwd":
        _rel_close(got[1].sum(0), ref[1], 1e-3)
    # rows [64 w0, 64 w0 + 640): 640 rows take the cooperative tiles
    w0 = (M // 64) // 2
    rows = slice(64 * w0, 64 * w0 + 640)
    assert not fa.gemm_plan(640, N, K, epi).pingpong
    part = run(rows)
    assert torch.equal(first(part), first(got)[rows])
    if epi == "rt_gelu_bwd":
        assert torch.equal(part[1], got[1][w0:w0 + 10])


def test_gemm_schedule_tally_credited_by_replays(dev):
    """A captured step's replays credit the schedule tallies with what
    its capture tallied, and count K2's launches alone as launches."""
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.training import graphs

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    M = 3 * 64 * sms
    a, w = _randn(dev, M, 64), _randn(dev, 64, 64, seed=1)
    bias = _randn(dev, 64, seed=2)
    R = torch.zeros(M, 64, device=dev)
    assert fa.gemm_plan(M, 64, 64, "residual").pingpong
    assert not fa.gemm_plan(M, 256, 64, "gelu").pingpong
    w4 = _randn(dev, 64, 256, seed=3)
    b4 = _randn(dev, 256, seed=4)

    def body(x):
        fa.gemm_bf16(x, w, "residual", bias=bias, out=R)
        return fa.gemm_bf16(x, w4, "gelu", bias=b4)

    step = graphs.CapturedStep(body)
    tallies = (fa.GEMM_BF16_PINGPONG, fa.GEMM_BF16_COOPERATIVE)
    before = [t.launches for t in tallies] + [fa.GEMM_BF16.launches]
    for _ in range(4):  # a warm-up, the capture, then replays
        step(a)
    torch.cuda.synchronize()
    (graph,) = step.graphs.values()
    assert graph.launches == 2
    assert graph.credit[fa.GEMM_BF16_PINGPONG] == 1
    assert graph.credit[fa.GEMM_BF16_COOPERATIVE] == 1
    after = [t.launches for t in tallies] + [fa.GEMM_BF16.launches]
    # the warm-up ran eagerly; the capture's launches are credited back
    assert [x - y for x, y in zip(after, before)] == [4, 4, 8]


# (H, W, C, dh, partition): gen1's (8, 10) and gen4's (6, 10) partitions
# (60 tokens: four 16-row tiles, the last padded) and (2, 3), at dh 16,
# 24 (padded to 32 for q k^T), 32 and 64, with one to four head groups.
_ATTN_GEOMS = [(16, 20, 64, 32, (8, 10)), (12, 12, 32, 16, (2, 3)),
               (16, 20, 96, 24, (8, 10)), (12, 20, 48, 24, (6, 10)),
               (12, 20, 128, 32, (6, 10)), (16, 20, 256, 64, (8, 10)),
               (12, 12, 48, 24, (2, 3)), (12, 20, 192, 64, (6, 10)),
               (16, 20, 512, 32, (8, 10))]


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("geom", _ATTN_GEOMS)
def test_partition_attention_kernel(dev, window, geom):
    from rvt_tpu_torch.ops import fused_attention as fa

    H, W, C, dh, part = geom
    qkv = _randn(dev, 3, H, W, 3 * C)
    got = fa.partition_attention(qkv, heads=C // dh, dim_head=dh, part=part,
                                 window=window)
    _close(got, fa.partition_attention_plain(qkv, C // dh, dh, part, window))


# (T, B, H, W): 35 pixels a lane (a ragged last 16-row tile, one cluster
# of rows) at T = 4, 21 and 1; 391 a lane over two lanes (several
# clusters, the last ragged); 632 rows (at C = 512 one unit per warp, 96
# rows per cluster, the last with 56).
@pytest.mark.parametrize("tbhw", [(4, 2, 5, 7), (21, 2, 5, 7), (1, 2, 5, 7),
                                  (3, 2, 17, 23), (2, 4, 2, 79)])
@pytest.mark.parametrize("C", [32, 48, 96, 128, 256, 512])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_lstm_scan_kernel(dev, C, xdtype, tbhw):
    from rvt_tpu_torch.ops import fused_scan as fs

    T, B, H, W = tbhw
    x = _randn(dev, T, B, H, W, C, dtype=xdtype)
    w = _randn(dev, 2 * C, 4 * C, scale=(2 * C) ** -0.5, seed=1)
    b = _randn(dev, 4 * C, scale=0.1, seed=2)
    h0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=3)
    c0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=4)
    n = fs.LSTM_SCAN.launches
    got = fs.fused_lstm_scan(x, w, b, h0, c0)
    assert fs.LSTM_SCAN.launches - n == fs.lstm_scan_launches(T, B * H * W,
                                                               C)
    ref = fs.lstm_scan_plain(x, w, b, h0, c0)
    for g, r in zip(got, ref):
        _close(g, r, atol=2e-2, rtol=2e-2)



@pytest.mark.parametrize("case", ["uniform", "clustered", "dropped",
                                  "bin_edges", "unsorted", "hot_pixel",
                                  "no_events", "zero_counts", "gen4_ds2",
                                  "odd_total"])
def test_stacked_histogram_kernel(dev, case):
    """Integer counts: the kernel equals its plain version exactly,
    whatever order its atomics ran in: t in any order, > 65,535 events in
    one bin (saturates, never wraps), N = 0, counts = 0 and counts > N,
    the ds2 retarget into gen4's 360x640 half grid, totals that are not
    a multiple of 16."""
    from rvt_tpu_torch.inference import ds2_retarget
    from rvt_tpu_torch.ops import voxelization as vx

    B, N, bins, H, W = 3, 5000, 10, 30, 37  # 3*2*10*30*37 % 16 = 8: tail
    if case == "hot_pixel":
        B, N = 2, 70_000
    elif case == "no_events":
        N = 0
    elif case == "gen4_ds2":
        B, N, H, W = 2, 200_000, 720, 1280
    elif case == "odd_total":
        H, W = 7, 9  # 3*2*10*7*9 % 16 = 4
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(lo, hi):
        return torch.randint(lo, hi, (B, N), generator=g, device=dev,
                             dtype=torch.int32)

    x, y, p = ints(0, W), ints(0, H), ints(0, 2)
    t = torch.sort(ints(0, 50_000), dim=1).values
    counts = torch.tensor([N, N - 17, 0][:B], dtype=torch.int32, device=dev)
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
    elif case == "unsorted":  # the bins span t[0] .. t[counts - 1]
        t = ints(0, 50_000)
        counts[2] = N + 5  # more than N counts as N
    elif case == "hot_pixel":  # lane 0: every event in one bin
        x[0], y[0], p[0], t[0] = 3, 4, 1, 7
        counts = torch.tensor([N, N + 9], dtype=torch.int32, device=dev)
    elif case == "zero_counts":
        counts.zero_()
    elif case == "gen4_ds2":
        x, y = ds2_retarget(x, y, bins, H // 2, W // 2)
        H, W = H // 2, W // 2
    n = vx.STACKED_HISTOGRAM.launches
    got = vx.stacked_histogram_batched(x, y, p, t, counts, bins, H, W)
    assert vx.STACKED_HISTOGRAM.launches == n + 1
    ref = vx.stacked_histogram_plain(x, y, p, t, counts, bins, H, W)
    assert got.dtype == torch.uint8 and torch.equal(got, ref)
    if case in ("clustered", "hot_pixel"):
        assert int(got[0].max()) == 255
    if case in ("no_events", "zero_counts"):
        assert int(got.max()) == 0
    # the workspace's counts are zero again: a second call agrees
    again = vx.stacked_histogram_batched(x, y, p, t, counts, bins, H, W)
    assert torch.equal(again, ref)


def _rel_close(got, ref, tol):
    """max |got - ref| <= tol * max |ref|: for sums whose order differs."""
    got, ref = got.float(), ref.float()
    scale = max(float(ref.abs().max()), 1e-6)
    err = float((got - ref).abs().max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("epi", ["bias", "gelu", "residual_ls", "rt_f32",
                                 "rt_bf16", "rt_acc", "rt_gelu_bwd"])
@pytest.mark.parametrize("mkn", _GEMM_SHAPES)
def test_gemm_train_kernel(dev, epi, mkn):
    """K2's training epilogues at the stage shapes, the small-M tiles and
    ragged M, K, N (40 = one partial tile); the gelu backward's column
    sums bit for bit across two runs."""
    from rvt_tpu_torch.ops import fused_attention as fa

    M, K, N = mkn
    rt = epi.startswith("rt_")
    a = _randn(dev, M, K)
    w = _randn(dev, *((N, K) if rt else (K, N)), scale=K ** -0.5, seed=1)
    kw = dict(bias=_randn(dev, N, scale=0.1, seed=2))
    if epi == "residual_ls":
        kw.update(gamma=_randn(dev, N, scale=0.3, dtype=torch.float32,
                               seed=4),
                  res_in=_randn(dev, M, N, dtype=torch.float32, seed=3))
    if epi == "rt_acc":
        R = _randn(dev, M, N, dtype=torch.float32, seed=3)
    if epi == "rt_gelu_bwd":
        kw["aux"] = _randn(dev, M, N, seed=5)
    n = fa.GEMM_BF16.launches
    want = epi in ("gelu", "residual_ls")

    def run(plain):
        extra = dict(out=R.clone()) if epi == "rt_acc" else {}
        return fa.gemm_bf16(a, w, epi, want_aux=want, plain=plain, **kw,
                            **extra)

    got, ref = run(False), run(True)
    assert fa.GEMM_BF16.launches == n + 1
    if epi == "residual_ls":  # the increment, as in test_gemm_kernel
        got = (got[0] - kw["res_in"], got[1])
        ref = (ref[0] - kw["res_in"], ref[1])
    if isinstance(ref, tuple):
        _close(got[0], ref[0])
        if epi == "rt_gelu_bwd":
            _rel_close(got[1], ref[1], 1e-3)
            again = run(False)
            assert torch.equal(got[0], again[0])
            assert torch.equal(got[1], again[1])
        else:  # the bf16 value before the epilogue
            _close(got[1], ref[1])
    else:
        _close(got, ref)
    if epi == "residual_ls":  # in place: out is res_in
        R2 = kw["res_in"].clone()
        out = fa.gemm_bf16(a, w, epi, out=R2, **dict(kw, res_in=R2))
        _close(out - kw["res_in"], ref[0])


@pytest.mark.parametrize("mkn", [(1000, 96, 40), (70000, 64, 192),
                                 (3000, 512, 256)]
                         + [(2 * H * W, Ka, Nb) for H, W, C in _STAGES
                            for Ka, Nb in ((C, 3 * C), (4 * C, C),
                                           (2 * C, 4 * C))]
                         + [(640, 1024, 2048), (1, 8, 40), (127, 40, 48),
                            (129, 48, 8)])
def test_wgrad_kernel(dev, mkn):
    """K6 with one and many row splits (ragged rows, a partial tile), at
    the stage shapes and the per-step path's small M; two runs bit for
    bit."""
    from rvt_tpu_torch.ops import fused_attention as fa

    M, Ka, Nb = mkn
    a, b = _randn(dev, M, Ka), _randn(dev, M, Nb, seed=1)
    got = fa.gemm_bf16_wgrad(a, b)
    _rel_close(got, fa.gemm_bf16_wgrad_plain(a, b), 1e-4)
    assert torch.equal(got, fa.gemm_bf16_wgrad(a, b))  # deterministic


@pytest.mark.parametrize("C", [32, 48, 64, 96, 192, 384, 512])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_ln_rows_bwd_kernel(dev, C, xdtype):
    from rvt_tpu_torch.ops import fused_attention as fa

    M = 1000
    x = _randn(dev, M, C, scale=2.0, dtype=xdtype)
    dy = _randn(dev, M, C, dtype=torch.float32, seed=1)
    s = _randn(dev, C, seed=2) + 1
    dres = _randn(dev, M, C, dtype=torch.float32, seed=3)
    dx, ds, db = fa.ln_rows_bwd_plain(x, dy, s, 1e-5)
    got, gs, gb = fa.ln_rows_bwd(x, dy, s, 1e-5, dres=dres.clone())
    _close(got, dres + dx, atol=1e-4, rtol=1e-4)
    _rel_close(gs, ds, 1e-4)
    _rel_close(gb, db, 1e-4)
    got_b, _, _ = fa.ln_rows_bwd(x, dy, s, 1e-5)
    assert got_b.dtype == torch.bfloat16
    _close(got_b, dx)


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("geom", [(16, 20, 64, 32, (8, 10)),
                                  (12, 12, 32, 16, (2, 3)),
                                  (16, 16, 128, 64, (8, 16)),
                                  (16, 20, 48, 24, (8, 10)),
                                  (12, 20, 96, 24, (6, 10)),
                                  (12, 20, 192, 32, (6, 10)),
                                  (16, 20, 384, 24, (8, 10)),
                                  (12, 12, 192, 24, (2, 3)),
                                  (12, 20, 512, 32, (6, 10))])
def test_partition_attention_bwd_kernel(dev, window, geom):
    """K7 at 80 tokens, at 6 (padded to 16) and at its limits (128 tokens,
    dh 64); the small presets' dh 24 (padded to 32 for the products over
    dh) at C 48-384, and gen4's (6, 10) partition (60 tokens: the last
    16-query tile padded)."""
    from rvt_tpu_torch.ops import fused_attention as fa

    H, W, C, dh, part = geom
    qkv = _randn(dev, 3, H, W, 3 * C)
    do = _randn(dev, 3, H, W, C, seed=1)
    kw = dict(heads=C // dh, dim_head=dh, part=part, window=window)
    n = fa.PARTITION_ATTENTION_BWD.launches
    got = fa.partition_attention_bwd(qkv, do, **kw)
    assert fa.PARTITION_ATTENTION_BWD.launches == n + 1
    ref = fa.partition_attention_bwd(qkv, do, plain=True, **kw)
    _close(got, ref, atol=2e-2, rtol=2e-2)


def test_train_reduce_kernels(dev):
    from rvt_tpu_torch.ops import fused_attention as fa

    x = _randn(dev, 5000, 96, dtype=torch.float32)
    _rel_close(fa.col_sum(x), x.sum(0), 1e-5)
    _rel_close(fa.col_sum(x.to(torch.bfloat16)),
               x.to(torch.bfloat16).float().sum(0), 1e-5)
    v, g = _randn(dev, 5000, 96, seed=1), _randn(dev, 96, dtype=torch.float32,
                                                 seed=2)
    got = fa.layer_scale_bwd(x, v, g)
    ref = fa.layer_scale_bwd_plain(x, v, g)
    assert torch.equal(got[0], ref[0])
    _rel_close(got[1], ref[1], 1e-5)
    _rel_close(got[2], ref[2], 1e-5)


_PRESET_C = [32, 48, 64, 96, 128, 192, 256, 384, 512]


@pytest.mark.parametrize("with_f32", [False, True], ids=["y", "y+yf"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", _PRESET_C)
def test_ln_rows_kernel_every_width(dev, C, dtype, with_f32):
    """K1 at every preset width, f32 and bf16 rows, with and without the
    f32 copy; the same rows give the same bits at 8 and 168 frames' worth
    of rows (the per-step and whole-window launches), and two runs agree."""
    from rvt_tpu_torch.ops import fused_attention as fa

    frame = 80  # rows of one gen1 stage-4 frame (8 x 10)
    x = _randn(dev, 168 * frame, C, scale=2.0, dtype=dtype) + 0.5
    s, b = _randn(dev, C, seed=1) + 1, _randn(dev, C, seed=2)
    n = fa.LN_ROWS.launches
    got = fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32)
    assert fa.LN_ROWS.launches == n + 1
    y = got[0] if with_f32 else got
    _close(y, fa.ln_rows_plain(x, s, b, 1e-5))
    if with_f32:
        assert torch.equal(got[1], y.float())
    again = fa.ln_rows(x, s, b, 1e-5, with_f32=with_f32)
    assert torch.equal(y, again[0] if with_f32 else again)
    for lo in (0, 37 * frame):  # 8 frames from the start and from within
        part = fa.ln_rows(x[lo:lo + 8 * frame].contiguous(), s, b, 1e-5,
                          with_f32=with_f32)
        assert torch.equal(part[0] if with_f32 else part,
                           y[lo:lo + 8 * frame])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [33, 40, 100, 1040])
def test_ln_rows_kernel_other_widths(dev, C, dtype):
    """K1 at widths no preset has: 1-element loads (33; 100 for bf16),
    lanes idle past C (40), a warp a row past 8 vectors a lane (1040
    f32)."""
    from rvt_tpu_torch.ops import fused_attention as fa

    x = _randn(dev, 300, C, scale=2.0, dtype=dtype) + 0.5
    s, b = _randn(dev, C, seed=1) + 1, _randn(dev, C, seed=2)
    y, yf = fa.ln_rows(x, s, b, 1e-5, with_f32=True)
    _close(y, fa.ln_rows_plain(x, s, b, 1e-5))
    assert torch.equal(yf, y.float())


@pytest.mark.parametrize("M", [13440, 13441, 5])
@pytest.mark.parametrize("C", _PRESET_C)
def test_col_sum_and_layer_scale_bwd_every_width(dev, C, M):
    """``col_sum`` at N = 3C (bf16 and f32) and ``layer_scale_bwd`` at C,
    at the stage-4 train rows, a ragged count and a few rows: one launch
    each, against the plain sums, bit for bit across two runs."""
    from rvt_tpu_torch.ops import fused_attention as fa

    dq = _randn(dev, M, 3 * C)
    for x in (dq, dq.float()):
        n = fa.TRAIN_REDUCE.launches
        got = fa.col_sum(x)
        assert fa.TRAIN_REDUCE.launches == n + 1
        _rel_close(got, x.float().sum(0), 1e-5)
        assert torch.equal(got, fa.col_sum(x))
    dR = _randn(dev, M, C, dtype=torch.float32, seed=1)
    v = _randn(dev, M, C, seed=2)
    g = _randn(dev, C, scale=0.3, dtype=torch.float32, seed=3)
    n = fa.TRAIN_REDUCE.launches
    got = fa.layer_scale_bwd(dR, v, g)
    assert fa.TRAIN_REDUCE.launches == n + 1
    ref = fa.layer_scale_bwd_plain(dR, v, g)
    assert torch.equal(got[0], ref[0])
    _rel_close(got[1], ref[1], 1e-5)
    _rel_close(got[2], ref[2], 1e-5)
    again = fa.layer_scale_bwd(dR, v, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("C", [33, 34])
def test_train_reduce_narrow_vectors(dev, C):
    """``col_sum`` (f32 and bf16) and ``layer_scale_bwd`` where 16 bytes do
    not divide the row: 2- and 1-element vectors, split into chunks."""
    from rvt_tpu_torch.ops import fused_attention as fa

    dq = _randn(dev, 4001, 3 * C)
    for x in (dq, dq.float()):
        _rel_close(fa.col_sum(x), x.float().sum(0), 1e-5)
    dR = _randn(dev, 4001, C, dtype=torch.float32, seed=1)
    v = _randn(dev, 4001, C, seed=2)
    g = _randn(dev, C, scale=0.3, dtype=torch.float32, seed=3)
    got = fa.layer_scale_bwd(dR, v, g)
    ref = fa.layer_scale_bwd_plain(dR, v, g)
    plan = fa.reduce_plan(4001, C)
    assert plan.vec < 4 and plan.chunks > 1
    assert torch.equal(got[0], ref[0])
    _rel_close(got[1], ref[1], 1e-5)
    _rel_close(got[2], ref[2], 1e-5)


@pytest.mark.parametrize("shape", [(13440, 256), (3, 12288), (1024, 2, 64),
                                   (5, 37), (700, 38)])
def test_sum_parts_kernel(dev, shape):
    """``sum_parts`` on K2's gelu partials at gen1 stage 1 ([13440, 256]),
    a few wide partials, K5's [n, 2, C] and a ragged width: one launch,
    against torch's sum, bit for bit across two runs."""
    from rvt_tpu_torch.ops import fused_attention as fa

    part = _randn(dev, *shape, dtype=torch.float32)
    n = fa.TRAIN_REDUCE.launches
    got = fa.sum_parts(part)
    assert fa.TRAIN_REDUCE.launches == n + 1
    assert got.shape == part.shape[1:]
    _rel_close(got, part.sum(0), 1e-5)
    assert torch.equal(got, fa.sum_parts(part))


# (B, H, W): 35 pixels a lane (70 rows: one ragged 32-row tile past two),
# 391 a lane (782 rows over several clusters, the last ragged), 632 rows
# (gen1 stage 4's 640 less one tile)
@pytest.mark.parametrize("bhw", [(2, 5, 7), (2, 17, 23), (4, 2, 79)])
@pytest.mark.parametrize("T", [1, 4, 21])
@pytest.mark.parametrize("C", [32, 48, 64, 96, 128, 192, 256, 384, 512])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_lstm_scan_bwd_kernel(dev, C, T, bhw, xdtype):
    """K8 (pack, the gates' K2 product, the reverse scan, dx's K2 product;
    at T = 1 the cell and one K2 product for dx and dh_0) + K6 against the
    plain BPTT at every preset width; all of K8's launches count on its
    own counter, none on K2's."""
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.ops import fused_scan as fs

    B, H, W = bhw
    x = _randn(dev, T, B, H, W, C, dtype=xdtype)
    w = _randn(dev, 2 * C, 4 * C, scale=(2 * C) ** -0.5, seed=1)
    b = _randn(dev, 4 * C, scale=0.1, seed=2)
    h0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=3)
    c0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=4)
    h_seq, c_seq, _, _ = fs.fused_lstm_scan(x, w, b, h0, c0, with_c_seq=True,
                                            plain=True)
    dh_seq = _randn(dev, T, B, H, W, C, seed=5)
    dhT = _randn(dev, B, H, W, C, dtype=torch.float32, seed=6)
    dcT = _randn(dev, B, H, W, C, dtype=torch.float32, seed=7)
    args = (x, w, b, h0, c0, h_seq, c_seq, dh_seq, dhT, dcT)
    n, n2 = fs.LSTM_SCAN_BWD.launches, fa.GEMM_BF16.launches
    got = fs.lstm_scan_bwd(*args)
    assert fs.LSTM_SCAN_BWD.launches - n == fs.lstm_scan_bwd_launches(
        T, B * H * W, C)
    assert fa.GEMM_BF16.launches == n2
    ref = fs.lstm_scan_bwd(*args, plain=True)
    for name, g_, r_ in zip(("dx", "dW", "db", "dh0", "dc0"), got, ref):
        assert g_.shape == r_.shape, name
        _rel_close(g_, r_, 2e-2)


def test_lstm_scan_with_c_seq_kernel(dev):
    """K4 with c_seq (the train forward) against its plain version."""
    from rvt_tpu_torch.ops import fused_scan as fs

    T, B, H, W = 4, 2, 5, 7
    for C in (32, 128, 256):
        x = _randn(dev, T, B, H, W, C, dtype=torch.float32)
        w = _randn(dev, 2 * C, 4 * C, scale=(2 * C) ** -0.5, seed=1)
        b = _randn(dev, 4 * C, scale=0.1, seed=2)
        h0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=3)
        c0 = _randn(dev, B, H, W, C, scale=0.5, dtype=torch.float32, seed=4)
        got = fs.fused_lstm_scan(x, w, b, h0, c0, with_c_seq=True)
        ref = fs.fused_lstm_scan(x, w, b, h0, c0, with_c_seq=True,
                                 plain=True)
        for g_, r_ in zip(got, ref):
            _close(g_, r_, atol=2e-2, rtol=2e-2)


def test_pair_train_kernels_vs_plain(dev):
    """FusedPairTrain forward and backward on the kernels against the same
    Function on the plain versions, on the card."""
    from rvt_tpu_torch.ops import fused_train as ft

    H, W, C, dh, part, N = 16, 10, 64, 32, (8, 10), 4
    g = torch.Generator(device=dev).manual_seed(0)

    def leaf(*shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g, device=dev) * scale + offset
        return t.to(dtype).requires_grad_(True)

    def block(sfn):
        out = [] if sfn else [leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2)]
        return out + [leaf(C, 3 * C, scale=C ** -0.5), leaf(3 * C, scale=0.1),
                      leaf(C, C, scale=C ** -0.5), leaf(C, scale=0.1),
                      leaf(C, scale=0.1, offset=0.3, dtype=torch.float32),
                      leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2),
                      leaf(C, 4 * C, scale=C ** -0.5), leaf(4 * C, scale=0.1),
                      leaf(4 * C, C, scale=(4 * C) ** -0.5), leaf(C, scale=0.1),
                      leaf(C, scale=0.1, offset=0.3, dtype=torch.float32)]

    x = leaf(N, H, W, C, scale=2.0)
    prm = [leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2)] + block(True) \
        + block(False)
    wgt = torch.randn((N, H, W, C), generator=g, device=dev)
    outs = []
    for plain in (False, True):
        for t in [x] + prm:
            t.grad = None
        cfg = ft.StageCfg(C // dh, dh, part, 1e-5, 1e-5, plain)
        y = ft.FusedPairTrain.apply(cfg, x, *prm)
        (y * wgt).sum().backward()
        outs.append([y.detach()] + [t.grad.clone() for t in [x] + prm])
    for got, ref in zip(*outs):
        _rel_close(got, ref, 2e-2)


@pytest.mark.parametrize("ds_ln", [True, False], ids=["ds_ln", "normed"])
def test_stage_step_train_kernels_vs_plain(dev, ds_ln):
    """Row 7, ``fused_stage_step_train``, over T = 3 carried steps on the
    kernels against the same loop on the plain versions: outputs and every
    gradient; it launches the kernels (and counts itself) only on the
    kernel side. With ``ds_ln=False`` (the token-mask path) the input is
    already normed and the LN affine gets no gradient from the stage."""
    from rvt_tpu_torch.ops import fused_scan as fs
    from rvt_tpu_torch.ops import fused_train as ft

    H, W, C, dh, part, B, T = 16, 10, 64, 32, (8, 10), 2, 3
    g = torch.Generator(device=dev).manual_seed(1)

    def leaf(*shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        t = torch.randn(shape, generator=g, device=dev) * scale + offset
        return t.to(dtype).requires_grad_(True)

    def block(sfn):
        out = [] if sfn else [leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2)]
        return out + [leaf(C, 3 * C, scale=C ** -0.5), leaf(3 * C, scale=0.1),
                      leaf(C, C, scale=C ** -0.5), leaf(C, scale=0.1),
                      leaf(C, scale=0.1, offset=0.3, dtype=torch.float32),
                      leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2),
                      leaf(C, 4 * C, scale=C ** -0.5), leaf(4 * C, scale=0.1),
                      leaf(4 * C, C, scale=(4 * C) ** -0.5), leaf(C, scale=0.1),
                      leaf(C, scale=0.1, offset=0.3, dtype=torch.float32)]

    x = leaf(T, B, H, W, C, scale=2.0)
    ds = [leaf(C, scale=0.2, offset=1), leaf(C, scale=0.2)]
    win, grid = block(True), block(False)
    lw = leaf(2 * C, 4 * C, scale=(2 * C) ** -0.5)
    lb = leaf(4 * C, scale=0.1)
    h0 = leaf(B, H, W, C, scale=0.3, dtype=torch.float32)
    c0 = leaf(B, H, W, C, scale=0.3, dtype=torch.float32)
    leaves = [x] + ds + win + grid + [lw, lb, h0, c0]
    wh = torch.randn((T, B, H, W, C), generator=g, device=dev)
    outs = []
    for plain in (False, True):
        for t in leaves:
            t.grad = None
        cfg = ft.StageCfg(C // dh, dh, part, 1e-5, 1e-5, plain, ds_ln)
        n_stage, n_k8 = ft.STAGE_STEP_TRAIN.launches, \
            fs.LSTM_SCAN_BWD.launches
        h, c, hs = h0, c0, []
        for t in range(T):
            h, c = ft.fused_stage_step_train(cfg, x[t], *ds, win, grid, lw,
                                             lb, h, c)
            hs.append(h.to(torch.bfloat16))
        loss = (torch.stack(hs).float() * wh).sum() + (c * wh[0]).sum()
        loss.backward()
        assert ft.STAGE_STEP_TRAIN.launches - n_stage == (0 if plain else T)
        # K8 at T = 1: pack, gates, cell, one product for dx and dh_0
        assert fs.LSTM_SCAN_BWD.launches - n_k8 == (
            0 if plain else T * fs.lstm_scan_bwd_launches(1, B * H * W, C))
        outs.append([torch.stack(hs).detach(), h.detach(), c.detach()]
                    + [t.grad for t in leaves])
    for i, (got, ref) in enumerate(zip(*outs)):
        if ref is None:  # the LN affine of a normed input
            assert not ds_ln and got is None and i in (4, 5)
            continue
        _rel_close(got, ref, 2e-2)


def _nms_cases():
    """(boxes [B, K, 4] xyxy, valid [B, K], threshold): dense random
    frames of gen1's 1,680 anchors with 1680, 700, 1 and 0 candidates; a
    chain of 600 boxes each overlapping only its neighbours (depth 600);
    pairs at IoU exactly 1/2 (kept at 1/2) and 0.4."""
    g = torch.Generator().manual_seed(0)
    B, K = 4, 1680
    xy = torch.rand(B, K, 2, generator=g) * 80
    wh = torch.rand(B, K, 2, generator=g) * 26 + 4
    n = torch.tensor([[K], [700], [1], [0]])
    x = torch.arange(600.0) * 3
    chain = torch.stack([x, torch.zeros_like(x), x + 10,
                         torch.full_like(x, 10)], -1)[None]
    pair = torch.tensor([[[0.0, 0, 2, 1], [0, 0, 1, 1], [5, 5, 7, 6],
                          [5, 5, 6, 6.5]]])
    return {"dense": (torch.cat([xy, xy + wh], -1), torch.arange(K) < n,
                      0.45),
            "chain": (chain, torch.ones(1, 600, dtype=torch.bool), 0.45),
            "at_threshold": (pair, torch.ones(1, 4, dtype=torch.bool), 0.5)}


@pytest.mark.parametrize("case", ["dense", "chain", "at_threshold"])
def test_nms_keep_kernel(dev, case):
    from rvt_tpu_torch.ops import boxes

    b, v, thr = (t.to(dev) if isinstance(t, torch.Tensor) else t
                 for t in _nms_cases()[case])
    n = boxes.NMS_KEEP.launches
    keep = boxes.nms_keep(b, v, thr)
    assert boxes.NMS_KEEP.launches == n + 1
    torch.cuda.synchronize()
    assert torch.equal(keep, boxes.nms_keep_plain(b, v, thr))
    if case == "chain":
        assert torch.equal(keep[0], torch.arange(600, device=dev) % 2 == 0)
    if case == "at_threshold":
        assert keep.tolist() == [[True, True, True, True]]


@pytest.mark.parametrize("agnostic", [False, True])
def test_postprocess_kernel_route_vs_plain(dev, agnostic):
    """Every anchor through ``nms_keep`` against the plain route (its
    512-candidate branch, Jacobi), bit for bit: 600 and 300 candidates."""
    from rvt_tpu_torch.ops import boxes

    g = torch.Generator().manual_seed(1)
    B, A, C = 2, 1680, 2
    pred = torch.zeros(B, A, 5 + C)
    pred[..., :2] = torch.rand(B, A, 2, generator=g) * 200
    pred[..., 2:4] = torch.rand(B, A, 2, generator=g) * 36 + 4
    pred[..., 4] = 0.01
    pred[..., 5:] = torch.rand(B, A, C, generator=g) * 0.7 + 0.3
    for b, k in enumerate((600, 300)):
        pred[b, torch.randperm(A, generator=g)[:k], 4] = 0.9
    for p in (pred, pred[1:]):
        p = p.to(dev)
        got = boxes.postprocess(p, C, 0.1, 0.45, 0, 300, agnostic)
        ref = boxes.postprocess(p, C, 0.1, 0.45, 0, 300, agnostic,
                                plain=True)
        assert all(torch.equal(a, r) for a, r in zip(got, ref))


# (B, T, layout, storage hw, model hw): RVT-B gen1 eval's window, one
# frame, a contiguous channel-last window (not the stored buffer's view),
# and a gen4-like frame whose staged rows (51.5 KB) pass a block's default
# 48 KB of shared memory
_WINDOW_S2D_CASES = {
    "gen1_eval": (8, 21, "stored", (240, 304), (256, 320)),
    "one_frame": (1, 1, "stored", (240, 304), (256, 320)),
    "channel_last": (2, 3, "contiguous", (240, 304), (256, 320)),
    "gen4_like": (1, 2, "stored", (360, 640), (384, 640))}


@pytest.mark.parametrize("case", sorted(_WINDOW_S2D_CASES))
def test_window_s2d_kernel(dev, case):
    """``csrc/window_s2d.cu`` against its plain version (20 channels),
    bit for bit, from a window of every byte value."""
    from rvt_tpu_torch.ops import s2d

    B, T, layout, hw, target = _WINDOW_S2D_CASES[case]
    g = torch.Generator(device=dev).manual_seed(3)
    stored = torch.randint(0, 256, (B, T, 20) + hw, generator=g,
                           device=dev, dtype=torch.uint8)
    ev = stored.permute(0, 1, 3, 4, 2)
    if layout == "contiguous":
        ev = ev.contiguous()
    n = s2d.WINDOW_S2D.launches
    got = s2d.window_s2d(ev, target)
    assert s2d.WINDOW_S2D.launches == n + 1
    torch.cuda.synchronize()
    ref = s2d.window_s2d_plain(ev, target)
    Hp, Wp = s2d.s2d_input_hw(target)
    assert got.shape == (T, B, Hp, Wp, 320) and got.is_contiguous()
    assert torch.equal(got, ref)


def test_captured_eval_step_takes_the_unblocked_window(dev):
    """The captured eval step fed the stored window's channel-last view
    (blocked in the step by ``window_s2d``) against the eager step fed the
    same window blocked on the host, bit for bit, over three carried
    windows; one kernel launch a replay."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _captured_eval_step_takes_the_unblocked_window(dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _captured_eval_step_takes_the_unblocked_window(dev):
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops import s2d
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.step import make_eval_step

    B, T, H, W = 2, 3, 64, 80
    cfg = _tiny_kernel_cfg(stem_s2d=True)
    g = torch.Generator(device=dev).manual_seed(4)
    stored = torch.randint(0, 6, (B, T, 20, H, W), generator=g, device=dev,
                           dtype=torch.uint8)
    ev = stored.permute(0, 1, 3, 4, 2)
    blocked = torch.from_numpy(s2d.host_space_to_depth(
        ev.cpu().numpy(), cfg.model.backbone.in_res_hw)).to(dev)
    fv = torch.tensor([[False, True, True]] * B, device=dev)
    first = torch.tensor([True, False], device=dev)
    model = init_detector(cfg.model, seed=0, device=dev)
    step = make_eval_step(model, cfg)
    with graphs.eager():
        ref = _carried(dev, cfg, step, 3, blocked, fv, first)
    n = s2d.WINDOW_S2D.launches
    got = _carried(dev, cfg, step, 3, ev, fv, first)
    assert s2d.WINDOW_S2D.launches == n + 3
    _equal_trees(got, ref)


def test_foreach_by_a_device_scalar(dev):
    """The optimizer divides and multiplies its lists by 0-d CUDA tensors
    (read on the device, as a captured step must). A product gives the
    bits of a Python-float factor; a quotient is the true quotient, as on
    the CPU and in optax (a Python-float divisor lets CUDA multiply by its
    reciprocal instead)."""
    xs = [_randn(dev, 1000, dtype=torch.float32, seed=s) for s in range(3)]
    for v in (0.8999999761581421, 3.7, 1e-3):
        d = torch.tensor(v, device=dev)
        for a, x in zip(torch._foreach_mul(xs, d), xs):
            assert torch.equal(a, x * v)
        for a, x in zip(torch._foreach_div(xs, d), xs):
            assert torch.equal(a, (x.cpu() / d.cpu()).to(dev))


def _tiny_kernel_cfg(stem_s2d):
    from dataclasses import replace

    from rvt_tpu_torch.config import preset

    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=3,
                 max_labels_per_frame=4, max_labeled_frames=2)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         stem_s2d=stem_s2d),
        postprocess=replace(cfg.model.postprocess, pre_nms_topk=0,
                            confidence_threshold=1e-4)))


def _equal_trees(a, b):
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


@pytest.mark.parametrize("path", ["eval", "train", "raw",
                                  "per_step_backbone", "trainer"])
def test_captured_steps_equal_eager(dev, tmp_path, path):
    """Each path's step captured (the first call a warm-up, then replays)
    against the same step eager (``graphs.eager()``) from the same state,
    bit for bit: the eval, raw and train steps' outputs, and for training
    the parameters, gradients, moments and BatchNorm buffers; the per-step
    train backbone's forward and backward (features, final states and
    every backbone gradient); the Trainer with token masks (its state and
    its last step's metrics). One replay of each under
    ``set_sync_debug_mode("error")`` (no host read left). cuDNN runs its
    deterministic algorithms: its default backward-filter ones may add in
    any order, and two eager steps would differ too."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _CAPTURED_VS_EAGER[path](dev, tmp_path)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _carried(dev, cfg, step, n, *args):
    """``n`` calls of ``step`` from zero states of two lanes, the states
    carried; every call's output."""
    from rvt_tpu_torch.models.backbone import zero_states

    states, outs = zero_states(cfg.model.backbone, 2, device=dev), []
    for _ in range(n):
        out = step(states, *args)
        states = out[0]
        outs.append(out)
    return outs


def _without_syncs(fn, *args):
    """``fn(*args)`` with every device synchronisation an error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _tiny_train_case(dev):
    """The tiny kernels config with the s2d stem, and a train step's
    arguments after the states: two lanes of three host-blocked frames,
    the last two labelled, lane 0 restarting."""
    from rvt_tpu_torch.ops.s2d import s2d_input_hw

    B, T = 2, 3
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = _tiny_kernel_cfg(stem_s2d=True)
    hp, wp = s2d_input_hw(cfg.model.backbone.in_res_hw)
    ev = torch.randint(0, 4, (B, T, hp, wp, 320), generator=g, device=dev,
                       dtype=torch.uint8)
    labels = torch.zeros(B, T, 4, 7, device=dev)
    labels[..., 1:3] = 20.0
    labels[..., 3:5] = 16.0
    mask = torch.ones(B, T, 4, dtype=torch.bool, device=dev)
    fv = torch.tensor([[False, True, True]] * B, device=dev)
    first = torch.tensor([True, False], device=dev)
    return cfg, (ev, labels, mask, fv, first)


def _same_training_state(models, opts):
    """Two models' state dicts and gradients and two optimizers' moments
    and counts, bit for bit."""
    for (na, a), (_, b) in zip(models[0].state_dict().items(),
                               models[1].state_dict().items()):
        assert torch.equal(a, b), na
    for pa, pb in zip(*(m.parameters() for m in models)):
        assert torch.equal(pa.grad, pb.grad)
    _equal_trees((opts[0].mu, opts[0].nu), (opts[1].mu, opts[1].nu))
    assert opts[0].count == opts[1].count


def _captured_eval_equals_eager(dev, tmp_path):
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.step import make_eval_step

    cfg, (ev, _, _, fv, first) = _tiny_train_case(dev)
    step = make_eval_step(init_detector(cfg.model, seed=0, device=dev), cfg)
    with graphs.eager():
        ref = _carried(dev, cfg, step, 3, ev, fv, first)
    got = _carried(dev, cfg, step, 3, ev, fv, first)
    _equal_trees(got, ref)
    again = _without_syncs(step, got[-1].states, ev, fv, first)
    assert len(step.graphs) == 1 and again.dets.shape == got[0].dets.shape


def _captured_train_equals_eager(dev, tmp_path):
    import copy

    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    cfg, args = _tiny_train_case(dev)
    model = init_detector(cfg.model, seed=0, device=dev)
    models = [model, copy.deepcopy(model)]
    opts = [make_optimizer(m.parameters(), cfg.training) for m in models]
    steps = [make_train_step(m, cfg, o) for m, o in zip(models, opts)]
    got = _carried(dev, cfg, steps[0], 3, *args)
    with graphs.eager():
        ref = _carried(dev, cfg, steps[1], 3, *args)
    _equal_trees(got, ref)
    _same_training_state(models, opts)
    _without_syncs(steps[0], got[-1][0], *args)


def _tiny_raw_case(dev):
    """The tiny kernels config without the s2d stem, and a raw step's
    arguments after the states: two lanes of 4,096 events (the second
    with half of them valid), lane 0 restarting."""
    B, N = 2, 4096
    g = torch.Generator(device=dev).manual_seed(0)

    def ints(hi):
        return torch.randint(0, hi, (B, N), generator=g, device=dev,
                             dtype=torch.int32)

    x, y, p = ints(80), ints(64), ints(2)
    t = torch.sort(ints(50000), dim=1).values
    counts = torch.tensor([N, N // 2], dtype=torch.int32, device=dev)
    first = torch.tensor([True, False], device=dev)
    return _tiny_kernel_cfg(stem_s2d=False), (x, y, p, t, counts, first)


def _captured_raw_equals_eager(dev, tmp_path):
    from rvt_tpu_torch.inference import make_raw_inference_step
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training import graphs

    cfg, args = _tiny_raw_case(dev)
    raw = make_raw_inference_step(
        init_detector(cfg.model, seed=0, device=dev), cfg)
    with graphs.eager():
        ref = _carried(dev, cfg, raw, 4, *args)
    got = _carried(dev, cfg, raw, 4, *args)
    _equal_trees(got, ref)
    _without_syncs(raw, got[-1][0], *args)


def _captured_per_step_backbone_equals_eager(dev, tmp_path):
    from rvt_tpu_torch.training import graphs

    case = _per_step_case(dev)
    step = graphs.CapturedStep(case["run"])
    with graphs.eager():
        ref = [step(case["ev"], case["states"]) for _ in range(3)]
    got = [step(case["ev"], case["states"]) for _ in range(3)]
    _equal_trees(got, ref)
    _without_syncs(step, case["ev"], case["states"])
    assert len(step.graphs) == 1


def _captured_trainer_equals_eager(dev, tmp_path):
    import contextlib
    from dataclasses import replace

    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops import fused_attention as fa
    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = _tiny_kernel_cfg(stem_s2d=False)
    cfg = replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, enable_masking=True)))
    items = _batches(cfg, 3, token_masks=True)
    trainers, last = {}, {}
    for mode in ("eager", "captured"):
        n = fa.GEMM_BF16_WGRAD.launches
        trainers[mode] = Trainer(cfg, TrainerConfig(
            max_steps=3, log_every_n_steps=1, ckpt_every_n_steps=100,
            gradflow_every_n_steps=0, detection_metrics_every_n_steps=0,
            prefetch_depth=2, ckpt_dir=str(tmp_path / mode)),
            model=init_detector(cfg.model, seed=0, device=dev))
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            last[mode] = trainers[mode].fit(iter(items))
        assert fa.GEMM_BF16_WGRAD.launches > n  # the train kernels ran
    got, ref = trainers["captured"], trainers["eager"]
    _same_training_state([got.model, ref.model],
                         [got.optimizer, ref.optimizer])
    keys = [k for k in last["eager"] if k != "train/frames_per_s"]
    assert keys and all(last["captured"][k] == last["eager"][k]
                        for k in keys)
    args = (zero_states(cfg.model.backbone, 2, device=dev),
            *got._to_device(items[0]))
    _without_syncs(got.train_step, *args)


_CAPTURED_VS_EAGER = {"eval": _captured_eval_equals_eager,
                      "train": _captured_train_equals_eager,
                      "raw": _captured_raw_equals_eager,
                      "per_step_backbone":
                          _captured_per_step_backbone_equals_eager,
                      "trainer": _captured_trainer_equals_eager}


def _close_mean(got, ref, atol, rtol, mean_tol):
    """|got - ref| <= atol + rtol*|ref| elementwise and mean |got - ref| <=
    mean_tol: a bf16 rounding may land one ulp apart where the kernels
    and the plain versions sum in other orders."""
    _close(got, ref, atol=atol, rtol=rtol)
    assert float((got.float() - ref.float()).abs().mean()) <= mean_tol


def _states_close(got, ref):
    for (hg, cg), (hr, cr) in zip(got, ref):
        _close_mean(hg, hr, 5e-2, 2e-2, 5e-3)
        _close_mean(cg, cr, 1e-1, 2e-2, 5e-3)


def _head_close(got, ref):
    scale = max(float(ref.abs().max()), 1.0)
    err = (got.float() - ref.float()).abs()
    assert float(err.max()) <= 0.05 * scale, (float(err.max()), scale)
    assert float(err.mean()) <= 5e-3 * scale, (float(err.mean()), scale)


def _stage_kernels_run(fn):
    """``fn()``, asserting that it launched the stages' kernels."""
    from rvt_tpu_torch.ops import fused_attention as fa

    n = fa.PARTITION_ATTENTION.launches
    out = fn()
    assert fa.PARTITION_ATTENTION.launches > n
    return out


def _tiny_kernel_model(cfg, dev):
    from rvt_tpu_torch.models.detector import init_detector

    return _drawn_gammas(init_detector(cfg.model, seed=0,
                                       device="cpu")).to(dev)


def _eval_vs_plain(dev, monkeypatch):
    from rvt_tpu_torch.training.step import make_eval_step

    cfg, (ev, _, _, fv, first) = _tiny_train_case(dev)
    model = _tiny_kernel_model(cfg, dev)
    step = make_eval_step(model, cfg)
    states = _carried(dev, cfg, step, 2, ev, fv, first)[-1].states
    got = _stage_kernels_run(lambda: step(states, ev, fv, first))
    ref = make_eval_step(model, cfg, plain=True)(states, ev, fv, first)
    _states_close(got.states, ref.states)
    _head_close(got.preds, ref.preds)
    assert torch.equal(got.frame_idx, ref.frame_idx)


def _raw_vs_plain(dev, monkeypatch):
    from rvt_tpu_torch.inference import event_frames, make_raw_inference_step
    from rvt_tpu_torch.models.detector import backbone_kernel_params
    from rvt_tpu_torch.training.step import reset_states

    cfg, args = _tiny_raw_case(dev)
    model = _tiny_kernel_model(cfg, dev)
    step = make_raw_inference_step(model, cfg)
    states = _carried(dev, cfg, step, 2, *args)[-1][0]
    got = _stage_kernels_run(lambda: step(states, *args))
    ref = make_raw_inference_step(model, cfg, plain=True)(states, *args)
    _states_close(got[0], ref[0])
    *events, first = args
    with torch.inference_mode():
        frames = event_frames(*events, cfg)
        assert torch.equal(frames, event_frames(*events, cfg, plain=True))
        params = backbone_kernel_params(model)
        st = reset_states(states, first)
        preds, _ = model(frames, st, params)
        preds_plain, _ = model(frames, st, params, plain=True)
    _head_close(preds, preds_plain)


def _shared_features(scan, kept):
    """A stand-in for the train step's backbone scan: the first call keeps
    its features in ``kept["first"]``; a later call keeps its own in
    ``kept["own"]`` and returns the first call's values with its own
    gradient (straight through: f + (first - f), the difference
    detached)."""
    def run(model, ev_seq, init_states, *args, **kw):
        feats, states = scan(model, ev_seq, init_states, *args, **kw)
        if "first" not in kept:
            kept["first"] = tuple(f.detach() for f in feats)
            return feats, states
        kept["own"] = tuple(f.detach() for f in feats)
        return tuple((f.float() + (r.float() - f.float()).detach()
                      ).to(f.dtype) for f, r in zip(feats, kept["first"])
                     ), states

    return run


def _train_vs_plain(dev, monkeypatch):
    import copy

    from rvt_tpu_torch.training import graphs
    from rvt_tpu_torch.training import step as step_mod
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    cfg, args = _tiny_train_case(dev)
    model = _tiny_kernel_model(cfg, dev)
    opt = make_optimizer(model.parameters(), cfg.training)
    step = make_train_step(model, cfg, opt)
    states = _carried(dev, cfg, step, 2, *args)[-1][0]
    pmodel, popt = copy.deepcopy((model, opt))
    # The kernel step's head is fed the plain step's features (their
    # values, with the kernel backbone's gradient) and runs its BatchNorm
    # on the plain version too: the neck, head, SimOTA and the loss see
    # the same inputs and run the same code on both sides, so the losses,
    # leaves and grad_norm differ only by what the backbone's kernels do.
    # Fed its own features, or on bn_act, the random bf16 head amplifies
    # one-ulp differences (bn_act, on an H100: the loss parts 3.5e-3
    # apart, a neck BatchNorm weight's gradient 7e-2 of its max); bn_act
    # is held against its plain version call by call (test_bn_act_*).
    kept = {}
    monkeypatch.setattr(step_mod, "scan_backbone",
                        _shared_features(step_mod.scan_backbone, kept))
    bn_route = step_mod.batch_norm_group
    monkeypatch.setattr(step_mod, "batch_norm_group",
                        lambda group, plain=False: bn_route(group,
                                                            plain=True))
    st_p, m_p = make_train_step(pmodel, cfg, popt, plain=True)(states,
                                                              *args)
    with graphs.eager():
        st_k, m_k = _stage_kernels_run(lambda: step(states, *args))
    for fk, fp in zip(kept["own"], kept["first"]):
        _close_mean(fk, fp, 5e-2, 2e-2, 5e-3)
    for k in ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg"):
        a, b = float(m_k[k]), float(m_p[k])
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-3), k
    nk, npl = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    assert abs(nk - npl) <= 2e-2 * npl
    for (name, p), q in zip(model.named_parameters(), pmodel.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            _rel_close(p.grad, q.grad, 5e-2)
    _states_close(st_k, st_p)
    bp = dict(pmodel.named_buffers())
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            _rel_close(buf, bp[name], 2e-2)


_ON_THE_KERNELS_VS_PLAIN = {"eval": _eval_vs_plain, "raw": _raw_vs_plain,
                            "train": _train_vs_plain}


@pytest.mark.parametrize("path", sorted(_ON_THE_KERNELS_VS_PLAIN))
def test_steps_on_the_kernels_equal_the_plain_versions(dev, monkeypatch,
                                                      path):
    """Each step at gen1 tiny (64, 80) on the kernels (bf16, LayerScale
    gammas drawn at 0.1) against the same step with ``plain=True`` from
    the same state, carried two calls: each stage's h within 5e-2 and c
    within 1e-1 (+ 2e-2 x |ref|, mean 5e-3); the eval step's head outputs
    within 0.05 x max|ref| (mean 5e-3 x) and its ``frame_idx`` equal; the
    raw step's voxelized frame equal and its head outputs as the eval
    step's; the train step, its head fed the plain step's features and
    on the plain BatchNorm, features as the states, the loss parts within
    1e-4, ``grad_norm`` within 2 %, every gradient leaf within 5e-2 of
    its max|ref|, the BatchNorm buffers within 2e-2."""
    _ON_THE_KERNELS_VS_PLAIN[path](dev, monkeypatch)


def _batches(cfg, n, token_masks, B=2):
    """``n`` Batches of random events at ``cfg``'s resolution, a box on
    every lane's last frame at t = 1 s (past the Prophesee protocol's
    0.5 s warm-up), the first batch restarting every lane, and with
    ``token_masks`` masks of about 20 % of the stage-1 tokens."""
    import numpy as np

    from rvt_tpu_torch.data.types import Batch

    rng = np.random.RandomState(0)
    T = cfg.dataset.sequence_length
    H, W = cfg.dataset.dataloading_hw
    M = cfg.dataset.max_labels_per_frame
    ps = cfg.model.backbone.stem_patch_size
    out = []
    for i in range(n):
        labels = np.zeros((B, T, M, 7), np.float32)
        label_mask = np.zeros((B, T, M), bool)
        labels[:, -1, 0] = (1_000_000.0, 8.0, 8.0, 30.0, 24.0, 0.0, 1.0)
        label_mask[:, -1, 0] = True
        out.append(Batch(
            ev_repr=rng.randint(0, 4, size=(B, T, H, W, 20)).astype(np.uint8),
            labels=labels, label_mask=label_mask,
            frame_valid=label_mask.any(-1),
            is_first_sample=np.full((B,), i == 0),
            is_padded=np.zeros((B, T), bool),
            token_mask=(rng.rand(B, T, H // ps, W // ps) < 0.2
                        if token_masks else None)))
    return out


def _per_step_case(dev, T=3, B=2):
    """The train backbone at gen1 tiny on the kernels, a window of ``T``
    frames of ``B`` lanes and the states one window carries into it;
    ``run(ev, states, per_step=True, plain=False)`` its forward and
    backward under a fixed linear loss on the features and final states:
    (outputs, every backbone gradient)."""
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import (fused_train_scan_backbone,
                                               init_detector)

    cfg = _tiny_kernel_cfg(stem_s2d=False)
    bb = cfg.model.backbone
    model = init_detector(cfg.model, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    ev = torch.randint(0, 8, (T, B) + tuple(bb.in_res_hw) + (20,),
                       generator=g, device=dev).float()
    with torch.no_grad():
        _, states = fused_train_scan_backbone(
            model, ev, zero_states(bb, B, device=dev))
    params = [p for n, p in model.named_parameters()
              if n.startswith("backbone.")]
    weights = []

    def run(ev, states, per_step=True, plain=False):
        model.zero_grad(set_to_none=True)
        feats, final = fused_train_scan_backbone(
            model, ev, states, per_step=per_step, plain=plain)
        outs = list(feats) + [t for hc in final for t in hc]
        if not weights:
            weights.extend(torch.randn(o.shape, generator=g, device=dev)
                           for o in outs)
        sum((o.float() * w).sum() for o, w in zip(outs, weights)).backward()
        return ([o.detach() for o in outs],
                [p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p) for p in params])

    return dict(run=run, ev=ev, states=states, T=T)


def test_per_step_backbone_equals_the_window_and_the_plain_versions(dev):
    """The per-step train backbone (``fused_train_scan_backbone(per_step=
    True)``: row 7 once a stage and step) on the kernels, one forward and
    backward under a linear loss: the forward bit for bit with the
    whole-window path's and every backbone gradient within 2e-2 of its
    max|ref|; against its plain versions the features and states within
    phase-3 tolerances and every gradient within 5e-2 of its max|ref|."""
    from rvt_tpu_torch.ops import fused_train as ft

    case = _per_step_case(dev)
    run, ev, states = case["run"], case["ev"], case["states"]
    n = ft.STAGE_STEP_TRAIN.launches
    got, ggot = run(ev, states)
    assert ft.STAGE_STEP_TRAIN.launches - n == case["T"] * 4
    win, gwin = run(ev, states, per_step=False)
    _equal_trees(got, win)
    for a, b in zip(ggot, gwin):
        _rel_close(a, b, 2e-2)
    ref, gref = run(ev, states, plain=True)
    n_f = len(got) - 2 * len(states)  # the features, then each h and c
    for i, (a, b) in enumerate(zip(got, ref)):
        is_c = i >= n_f and (i - n_f) % 2 == 1
        _close(a, b, atol=1e-1 if is_c else 5e-2, rtol=2e-2)
    for a, b in zip(ggot, gref):
        _rel_close(a, b, 5e-2)


@pytest.mark.parametrize("variant", ["plain", "detections"])
def test_one_nccl_rank_dp_step_is_the_plain_step(dev, tmp_path, variant):
    """One rank over NCCL in this process (a world of one): the dp train
    step, captured, bit for bit with the same captured step without a
    group over four carried steps, for both variants the Trainer runs
    (the plain step, and the one with detections and parameter metrics):
    every output, then the parameters, BatchNorm buffers, gradients and
    moments; each kernel launched as often."""
    import copy
    import gc

    import torch.distributed as dist

    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops.kernels import COUNTERS
    from rvt_tpu_torch.parallel.mesh import init_process_group, make_mesh
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_train_step

    kw = ({} if variant == "plain"
          else dict(with_detections=True, with_param_metrics=True))
    cfg, args = _tiny_train_case(dev)
    base = init_detector(cfg.model, seed=0, device=dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    init_process_group(dev, init_method=f"file://{tmp_path}/store", rank=0,
                       world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl"
        models, opts, outs, launched = [], [], [], []
        for group in (None, mesh.group):
            models.append(copy.deepcopy(base))
            opts.append(make_optimizer(models[-1].parameters(),
                                       cfg.training))
            step = make_train_step(models[-1], cfg, opts[-1], group=group,
                                   **kw)
            before = {c.name: c.launches for c in COUNTERS}
            outs.append(_carried(dev, cfg, step, 4, *args))
            launched.append({c.name: c.launches - before[c.name]
                             for c in COUNTERS})
            assert len(step.graphs) == 1
            del step  # a graph that captured collectives goes first
            gc.collect()
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    _equal_trees(outs[1], outs[0])
    _same_training_state(models, opts)
    assert launched[1] == launched[0]
    assert launched[1]["lstm_scan_bwd"] > 0 and launched[1]["bn_act"] > 0
    assert (launched[1]["nms_keep"] > 0) == (variant == "detections")


_TINY_BOXES = ((16.0, 16.0, 32.0, 32.0, 0), (48.0, 16.0, 32.0, 32.0, 0),
               (24.0, 28.0, 32.0, 32.0, 1))


def _memory_recordings(lengths, hw, seed):
    """One ``Recording`` a length held in memory (the card's machine has
    no h5py): uint8 stacked histograms [n, 20, H, W] in [0, 8) from a
    numpy seed, and three 32x32 boxes on every 5th frame, two of them
    where the random head's stride-32 boxes lie, stamped 50 ms apart from
    1 s."""
    import numpy as np

    from rvt_tpu_torch.data.labels import LabelStore
    from rvt_tpu_torch.data.sequence import Recording

    H, W = hw

    class MemoryRecording(Recording):
        def __init__(self, rec_seed, n):
            rng = np.random.RandomState(rec_seed)
            self.path, self.max_labels = None, 48
            self.prefer_raw_chunks, self._h5, self._data = False, None, None
            self.ev = rng.randint(0, 8, size=(n, 20, H, W), dtype=np.uint8)
            self.num_ev_repr, self.ev_shape = n, (20, H, W)
            self.ev_dtype = self.ev.dtype
            labelled = np.arange(4, n, 5)
            self.objframe_idx_2_repr_idx = labelled
            self.repr_idx_2_objframe_idx = {int(r): i
                                            for i, r in enumerate(labelled)}
            rows = [(1e6 + 5e4 * r, *b, 1.0) for r in labelled
                    for b in _TINY_BOXES]
            self.label_store = LabelStore(
                np.asarray(rows, np.float32),
                np.arange(0, len(rows), len(_TINY_BOXES)), input_size_hw=hw)

        def read_ev_repr(self, start, end):
            assert 0 <= start < end <= self.num_ev_repr
            return self.ev[start:end]

    return [MemoryRecording(seed + i, n) for i, n in enumerate(lengths)]


def _tiny_cfg(T, conf=None):
    """gen1 tiny at (64, 80) as it ships (f32, the module path), with
    ``conf`` as its confidence threshold."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset

    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=T)
    if conf is None:
        return cfg
    return replace(cfg, model=replace(cfg.model, postprocess=replace(
        cfg.model.postprocess, confidence_threshold=conf)))


def _drawn_gammas(model):
    """LayerScale gammas drawn at 0.1 (they start at 1e-5), so that the
    attention blocks shape the output the tests compare."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.normal_(0.0, 0.1, generator=g)
    return model


def _recorded_evaluators(monkeypatch):
    """Keep the PropheseeEvaluator each ``run_streaming_eval`` makes."""
    from rvt_tpu_torch.training import evaluator_loop as el

    made = []

    class Recorded(el.PropheseeEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(el, "PropheseeEvaluator", Recorded)
    return made


_STATS = {"AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L"}


def test_streaming_eval_equals_the_windows_fed_by_hand(dev):
    """``run_streaming_eval`` on the config ``cli.validate --serve_fused``
    builds (bf16, the s2d stem, the kernels; gen1 tiny at (64, 80), T =
    5, confidence 1e-4 so that NMS sees candidates) over in-memory
    recordings, lanes restarting mid-run and padded fill windows among
    them, against the same windows fed by hand (the pinned feed,
    ``make_eval_step``, ``iter_batch_detections``, a PropheseeEvaluator):
    the metrics bit for bit, each kernel launched as often, ``window_s2d``
    once a window."""
    import math

    from rvt_tpu_torch.cli.validate import serve_fused_config
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops.kernels import COUNTERS
    from rvt_tpu_torch.training.evaluator_loop import (fetch_outputs,
                                                       iter_batch_detections,
                                                       run_streaming_eval)
    from rvt_tpu_torch.training.feed import (PinnedFeed, stored_layout,
                                             window_input)
    from rvt_tpu_torch.training.step import make_eval_step

    B = 2
    cfg = serve_fused_config(_tiny_cfg(5, conf=1e-4))
    model = _drawn_gammas(init_detector(cfg.model, device="cpu")).to(dev)
    views = [StreamView(r, 5) for r in _memory_recordings(
        (23, 17, 12, 30, 9), (64, 80), seed=100)]
    plans = list(EvalStreamScheduler(views, B).plan_batches())
    assert any(p.window_idx < 0 for b in plans for p in b)  # fill windows
    assert any(p.window_idx == 0 for b in plans[1:] for p in b)  # restarts

    def launches():
        return {c.name: c.launches for c in COUNTERS}

    before = launches()
    metrics = run_streaming_eval(model, cfg, iter(EvalStreamScheduler(
        views, B)), B, device=dev)
    loop = {k: v - before[k] for k, v in launches().items()}
    batches = list(EvalStreamScheduler(views, B))
    step, feed = make_eval_step(model, cfg), PinnedFeed(dev)
    evaluator = PropheseeEvaluator("gen1", False)
    states = zero_states(cfg.model.backbone, B, device=dev)
    bb = cfg.model.backbone
    before = launches()
    for b in batches:
        ev, stored = stored_layout(b.ev_repr)
        ev, fv, first = feed([ev, b.frame_valid, b.is_first_sample])
        out = step(states, window_input(ev, stored, bb.in_res_hw,
                                        bb.stem_s2d), fv, first)
        states = out.states
        frames = list(iter_batch_detections(b, *fetch_outputs(
            (out.dets, out.det_valid, out.frame_idx, out.gval), dev)()))
        if frames:
            evaluator.add_labels([f[2] for f in frames])
            evaluator.add_predictions([f[3] for f in frames])
    assert {k: v - before[k] for k, v in launches().items()} == loop
    assert loop["window_s2d"] == len(batches) and loop["nms_keep"] > 0
    assert set(metrics) == _STATS and all(math.isfinite(v)
                                          for v in metrics.values())
    H, W = cfg.dataset.dataloading_hw
    assert evaluator.evaluate_buffer(img_height=H, img_width=W) == metrics


def _same_buffers(a, b):
    """Two PropheseeEvaluators hold the same frames bit for bit."""
    import numpy as np

    return (len(a._labels) == len(b._labels)
            and len(a._predictions) == len(b._predictions)
            and all(np.array_equal(x, y) for x, y in zip(
                a._labels + a._predictions, b._labels + b._predictions)))


def test_trainer_validates_each_steps_weights(dev, tmp_path, monkeypatch):
    """The Trainer on the train kernels (gen1 tiny at (64, 80), bf16, T =
    5) validating every step through ``run_streaming_eval`` over
    in-memory recordings: each validation's detections and metrics equal
    a fresh loop's on that step's weights, the two steps' detections
    differ, and ``cli.validate``'s loader restores the best slot to its
    metrics bit for bit."""
    from dataclasses import replace

    from rvt_tpu_torch.cli.validate import load_model
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.models.detector import RVTDetector, init_detector
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=5)
    cfg = replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True),
        postprocess=replace(cfg.model.postprocess,
                            confidence_threshold=1e-4)))
    views = [StreamView(r, 5) for r in _memory_recordings(
        (23, 17, 12, 30), (64, 80), seed=100)]

    def loop(model):
        return run_streaming_eval(model, cfg, iter(EvalStreamScheduler(
            views, 2)), 2, device=dev)

    snaps, seen = [], []

    def eval_fn(model):
        snaps.append({k: v.detach().clone()
                      for k, v in model.state_dict().items()})
        seen.append(loop(model))
        return seen[-1]

    made = _recorded_evaluators(monkeypatch)
    trainer = Trainer(cfg, TrainerConfig(
        max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=100,
        val_every_n_steps=1, gradflow_every_n_steps=0,
        detection_metrics_every_n_steps=0, prefetch_depth=2,
        ckpt_dir=str(tmp_path / "run")),
        model=_drawn_gammas(init_detector(cfg.model, device="cpu")).to(dev))
    trainer.fit(iter(_batches(cfg, 2, token_masks=False)), eval_fn=eval_fn)
    assert len(seen) == 2 and all(set(m) == _STATS for m in seen)
    assert not _same_buffers(made[0], made[1])
    for i, snap in enumerate(snaps):
        fresh = RVTDetector(cfg.model)
        fresh.load_state_dict(snap, strict=True)
        assert loop(fresh.to(dev).eval()) == seen[i]
        assert _same_buffers(made[-1], made[i])
    best = trainer.ckpt.best_step()
    assert best in (1, 2)
    assert loop(load_model(tmp_path / "run", cfg, dev)) == seen[best - 1]


def _canonical_rows(p):
    """Detection rows by box corner and size rounded to the pixel: the
    order of rows whose scores tie within rounding is not the
    protocol's."""
    import numpy as np

    key = np.round(np.stack([p["x"], p["y"], p["w"], p["h"]])).astype(int)
    return p[np.lexsort(key[::-1])]


def test_module_path_on_the_card_equals_the_cpu(dev, monkeypatch):
    """gen1 tiny at (64, 80), T = 5, as it ships (f32, the module path) on
    the card against the CPU from the same weights: the eval step over a
    window, every stage's states and the head outputs within 1e-4 of
    max|ref|; on the card a step at a time over the window bit for bit
    with the window scan (features and states); ``run_streaming_eval``
    over in-memory recordings, every labelled frame's detections (counts,
    classes and times equal; boxes and scores within 1e-4 of max|ref|)
    and the six stats within 1e-4. No stage kernel runs on the card: the
    only kernel launched is the card's NMS, ``nms_keep``. Every anchor
    enters NMS (threshold 1e-6) and class 1's biases sit 1 below class
    0's, so that no class decision is a near-tie of two 0.01 priors."""
    import copy

    import numpy as np

    from rvt_tpu_torch.data.sequence import StreamView
    from rvt_tpu_torch.data.streaming import EvalStreamScheduler
    from rvt_tpu_torch.models import detector as det
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.ops.kernels import COUNTERS
    from rvt_tpu_torch.training.evaluator_loop import run_streaming_eval
    from rvt_tpu_torch.training.step import make_eval_step, pad_ev_repr

    cfg = _tiny_cfg(5, conf=1e-6)
    assert det.stage_routes(cfg.model) == ["modules"] * 4
    cpu_model = _drawn_gammas(det.init_detector(cfg.model, device="cpu"))
    with torch.no_grad():
        for name, p in cpu_model.named_parameters():
            if name.startswith("yolox_head.cls_preds") and name.endswith(
                    "bias"):
                p[1:] -= 1.0
    card_model = copy.deepcopy(cpu_model).to(dev)
    before = {c.name: c.launches for c in COUNTERS}

    # one window through the eval step
    g = torch.Generator().manual_seed(0)
    ev = torch.randint(0, 8, (2, 5, 64, 80, 20), generator=g,
                       dtype=torch.uint8)
    fv, first = torch.ones(2, 5, dtype=torch.bool), torch.ones(
        2, dtype=torch.bool)
    ref = make_eval_step(cpu_model, cfg)(
        zero_states(cfg.model.backbone, 2, device="cpu"), ev, fv, first)
    got = make_eval_step(card_model, cfg)(
        zero_states(cfg.model.backbone, 2, device=dev), ev.to(dev),
        fv.to(dev), first.to(dev))
    for (hg, cg), (hr, cr) in zip(got.states, ref.states):
        _rel_close(hg.cpu(), hr, 1e-4)
        _rel_close(cg.cpu(), cr, 1e-4)
    _rel_close(got.preds.cpu(), ref.preds, 1e-4)
    with torch.inference_mode():
        seq = pad_ev_repr(ev.to(dev), cfg.model.backbone.in_res_hw,
                          None).transpose(0, 1)
        feats, states = det.scan_backbone(card_model, seq, got.states)
        st = got.states
        for t in range(seq.shape[0]):
            f, st = card_model.forward_backbone(seq[t], st)
            for i, s in enumerate(cfg.model.fpn.in_stages):
                assert torch.equal(f[s], feats[i][t])
    _equal_trees(st, states)

    # the validation loop over recordings
    views = [StreamView(r, 5) for r in _memory_recordings(
        (23, 17, 12, 30), (64, 80), seed=100)]
    made = _recorded_evaluators(monkeypatch)
    ref = run_streaming_eval(cpu_model, cfg, iter(EvalStreamScheduler(
        views, 2)), 2, device="cpu")
    got = run_streaming_eval(card_model, cfg,
                             iter(EvalStreamScheduler(views, 2)), 2,
                             device=dev)
    assert {c.name for c in COUNTERS
            if c.launches != before[c.name]} == {"nms_keep"}
    assert set(ref) == _STATS
    assert max(abs(got[k] - ref[k]) for k in ref) <= 1e-4
    frames = list(zip(made[1]._predictions, made[0]._predictions))
    assert frames and len(made[1]._predictions) == len(
        made[0]._predictions)
    for a, b in frames:
        assert len(a) == len(b)
        a, b = _canonical_rows(a), _canonical_rows(b)
        assert np.array_equal(a["class_id"], b["class_id"])
        assert np.array_equal(a["t"], b["t"])
        for f in ("x", "y", "w", "h", "class_confidence"):
            scale = max(np.abs(b[f].astype(np.float64)).max(initial=0.0),
                        1e-6)
            assert np.abs(a[f] - b[f]).max(initial=0.0) <= 1e-4 * scale, f


def test_train_cli_step_on_the_card_equals_the_cpu(dev, tmp_path):
    """The train CLI's first step (``build_train_scheduler``'s mixed batch
    from in-memory recordings, the Trainer) at gen1 tiny (64, 80), B = 2,
    T = 5, in f32 on the module path, on the card against the CPU from the
    same weights and batch: the loss parts and grad_norm within 1e-4 of
    their magnitude."""
    import copy
    from dataclasses import replace

    from rvt_tpu_torch.cli.train import build_train_scheduler
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = _tiny_cfg(5)
    cfg = replace(cfg, batch_size=replace(cfg.batch_size, train=2, eval=2),
                  training=replace(cfg.training, precision="32"))
    batch = next(iter(build_train_scheduler(cfg, _memory_recordings(
        (23, 17, 12, 30), (64, 80), seed=300), seed=0)))
    cpu_model = _drawn_gammas(init_detector(cfg.model, device="cpu"))
    metrics = {}
    for where, model in (("cpu", copy.deepcopy(cpu_model)),
                         ("card", copy.deepcopy(cpu_model).to(dev))):
        trainer = Trainer(cfg, TrainerConfig(
            max_steps=1, log_every_n_steps=1, ckpt_every_n_steps=100,
            gradflow_every_n_steps=0, detection_metrics_every_n_steps=0,
            prefetch_depth=0, ckpt_dir=str(tmp_path / where)), model=model)
        metrics[where] = trainer.fit(iter([batch]))
    ref, got = metrics["cpu"], metrics["card"]
    keys = [k for k in ref if k != "train/frames_per_s"]
    assert "grad_norm" in keys and "loss" in keys
    for k in keys:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1e-30), k


def test_capture_survives_the_collector(dev):
    """A step captured while unreachable steps (held in reference cycles)
    wait for the cyclic collector: a graph the collector destroys during a
    capture breaks that capture, so ``CapturedStep`` collects first and
    holds the collector off until the capture has ended."""
    import gc

    from rvt_tpu_torch.training import graphs

    def dropped_step():
        x = torch.zeros(1000, device=dev)
        step = graphs.CapturedStep(lambda a: (a * 2 + x).sum(0))
        for _ in range(2):  # the warm-up, then the capture
            step(torch.ones(1000, device=dev))
        assert len(step.graphs) == 1
        step.cycle = step  # only the collector can free it

    old = gc.get_threshold()
    try:
        for _ in range(3):
            dropped_step()
        gc.set_threshold(1)  # a collection at nearly every allocation
        step = graphs.CapturedStep(
            lambda a: [a * float(i) for i in range(200)])
        a = torch.ones(10, device=dev)
        step(a)
        out = step(a)
    finally:
        gc.set_threshold(*old)
    torch.cuda.synchronize()
    assert len(step.graphs) == 1 and torch.equal(out[3], a * 3)


def test_traced_replays_tile_their_layers(dev, monkeypatch):
    """A captured eval, train and raw step: with tracing off a replay
    makes no event and no record; with it on, a replay's layers are the
    step body's marks in order (the train step's ``backbone_bwd`` from the
    gradient hook, captured in the graph), each above zero, summing to
    the replay's first-to-last device interval within 1 %, with the
    step's launches and NMS candidates on the ``step`` span, the
    candidates a plain count of the boxes above the confidence threshold
    in that replay's head outputs. Traced calls back to back wait for no
    replay, and each replay, past a full turn of the ring, reads its own
    row."""
    from rvt_tpu_torch.inference import make_raw_inference_step
    from rvt_tpu_torch.models.backbone import zero_states
    from rvt_tpu_torch.models.detector import init_detector
    from rvt_tpu_torch.ops.s2d import s2d_input_hw
    from rvt_tpu_torch.training.optimizer import make_optimizer
    from rvt_tpu_torch.training.step import make_eval_step, make_train_step
    from rvt_tpu_torch.utils import timers

    B, T = 2, 3
    g = torch.Generator(device=dev).manual_seed(0)
    cfg, raw_cfg = (_tiny_kernel_cfg(stem_s2d=s) for s in (True, False))
    conf = cfg.model.postprocess.confidence_threshold
    hp, wp = s2d_input_hw(cfg.model.backbone.in_res_hw)
    ev = torch.randint(0, 4, (B, T, hp, wp, 320), generator=g, device=dev,
                       dtype=torch.uint8)
    fv = torch.tensor([[False, True, True]] * B, device=dev)
    first = torch.tensor([True, False], device=dev)
    labels = torch.zeros(B, T, 4, 7, device=dev)
    labels[..., 1:3] = 20.0
    labels[..., 3:5] = 16.0
    mask = torch.ones(B, T, 4, dtype=torch.bool, device=dev)
    model = init_detector(cfg.model, seed=0, device=dev)
    raw_model = init_detector(raw_cfg.model, seed=0, device=dev)
    head = []  # the raw step's head outputs: the captured tensor
    raw_model.register_forward_hook(lambda m, i, out: head.append(out[0]))
    N = 4096
    xyp = [torch.randint(0, hi, (B, N), generator=g, device=dev,
                         dtype=torch.int32) for hi in (80, 64, 2)]
    t = torch.sort(torch.randint(0, 50000, (B, N), generator=g, device=dev,
                                 dtype=torch.int32), dim=1).values
    counts = torch.tensor([N, N // 2], dtype=torch.int32, device=dev)
    states = zero_states(cfg.model.backbone, B, device=dev)
    opt = make_optimizer(model.parameters(), cfg.training)
    steps = [("eval", make_eval_step(model, cfg), (ev, fv, first), B * 2),
             ("train", make_train_step(model, cfg, opt),
              (ev, labels, mask, fv, first), None),
             ("raw", make_raw_inference_step(raw_model, raw_cfg),
              (*xyp, t, counts, first), B)]
    made = [0]

    class Counted(torch.cuda.Event):
        def __new__(cls, *a, **k):
            made[0] += 1
            return super().__new__(cls, *a, **k)

    def above(preds):  # the steps' score, in their dtype
        p = torch.sigmoid(preds[..., 4:])
        return int((p[..., 0] * p[..., 1:].amax(-1) >= conf).sum())

    def no_wait(self):
        raise AssertionError("a traced call waited for a replay")

    layers = {"eval": ["input", "backbone", "detect", "postprocess"],
              "train": ["input", "backbone", "detect", "loss", "detect_bwd",
                        "backbone_bwd", "optimizer"],
              "raw": ["input", "backbone", "detect", "postprocess"]}
    timers.reset()
    try:
        for kind, step, args, frames in steps:
            for _ in range(3):  # the warm-up and capture, two replays
                step(states, *args)
            assert len(step.graphs) == 1
            monkeypatch.setattr(torch.cuda, "Event", Counted)
            step(states, *args)
            torch.cuda.synchronize()
            assert made[0] == 0 and timers.records() == []
            monkeypatch.undo()
            timers.enable(True)
            out = step(states, *args)
            timers.enable(False)
            if kind == "raw":
                torch.cuda.synchronize()
                want = above(head[-1])
            elif kind == "eval":
                want = above(out.preds)
            timers.summary()
            recs = timers.records()
            (replay,) = [r for r in recs if r.name == "step.replay"]
            got = [r for r in recs if r.pid == replay.rid]
            assert [r.name for r in got] == layers[kind], kind
            assert all(r.device_s > 0 for r in got), kind
            total = sum(r.device_s for r in got)
            assert abs(total - replay.device_s) <= 0.01 * replay.device_s
            (launch,) = [r for r in recs if r.name == "launches"]
            assert launch.parent == "step" and launch.value > 0
            nms = [r for r in recs if r.name == "nms_candidates"]
            assert [r.items for r in nms] == ([frames] if frames else [])
            if frames:
                assert nms[0].value == want > 0, kind
            timers.reset()
        # back to back, past a turn of the ring: no call waits until the
        # ring comes round, and every replay reads its own row; a traced
        # replay read a turn later, untraced, still reads its own counts
        kind, step, args, _ = steps[2]
        timers.enable(True)
        step(states, *args)
        timers.enable(False)
        torch.cuda.synchronize()
        want = above(head[-1])
        for i in range(timers.RING + 1):
            step(states, *args)
        (nms,) = [r for r in timers.records() if r.name == "nms_candidates"]
        assert nms.value == want > 0
        timers.reset()
        n = timers.RING + 6
        monkeypatch.setattr(torch.cuda.Event, "synchronize", no_wait)
        timers.enable(True)
        for i in range(timers.RING - 1):
            step(states, *args)
        monkeypatch.undo()
        for i in range(n - timers.RING + 1):
            step(states, *args)
        timers.enable(False)
        timers.summary()
        recs = timers.records()
        replays = [r for r in recs if r.name == "step.replay"]
        assert len(replays) == n
        for replay in replays:
            got = [r for r in recs if r.pid == replay.rid]
            assert [r.name for r in got] == layers[kind]
            total = sum(r.device_s for r in got)
            assert abs(total - replay.device_s) <= 0.01 * replay.device_s
            assert 0 < replay.device_s < 1.0
    finally:
        timers.enable(False)
        timers.reset()


def bn_act_calls(dataset, size, frames, dev, seed=0):
    """Every train-mode BaseConv of ``preset(dataset, size)``'s neck and
    head (bf16 convs) on ``frames`` gathered frames at the preset's
    padded input, as the train cells run them: a list of (y, the
    gradient the BatchNorm's backward receives, its BatchNorm, act),
    recorded on the plain route under a random linear loss. The layouts
    are the convs' own (the first neck conv's channels_last, NCHW after
    the first concatenation) and the gradients the autograd hands over
    (channel slices of the concatenations' gradients)."""
    from dataclasses import replace

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models import yolox
    from rvt_tpu_torch.models.detector import init_detector

    cfg = preset(dataset, size)
    model = init_detector(replace(cfg.model, compute_dtype="bfloat16"),
                          seed=seed, device=dev).train()
    fpn = model.fpn
    chans = (fpn.reduce_conv1.conv.out_channels,
             fpn.lateral_conv0.conv.out_channels,
             fpn.lateral_conv0.conv.in_channels)
    H, W = cfg.model.backbone.in_res_hw
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(frames, H // s, W // s, c, generator=g, device=dev
                         ).to(torch.bfloat16)
             for s, c in zip((8, 16, 32), chans)]
    calls, real = [], yolox.batch_norm_act_train

    def record(y, bn, act, group=None, momentum=0.9, *, plain=False):
        out = real(y, bn, act, group, momentum, plain=True)
        entry = [y.detach(), None, bn, act]
        calls.append(entry)
        out.register_hook(lambda gr: entry.__setitem__(1, gr.detach()))
        return out

    yolox.batch_norm_act_train = record
    try:
        preds = model.forward_detect(feats)
        w = torch.randn(preds.shape, generator=g, device=dev) * 1e-2
        (preds * w).sum().backward()
    finally:
        yolox.batch_norm_act_train = real
    return calls


def bn_act_vs_plain(y, gr, bn, act):
    """One BaseConv's BatchNorm + activation, each kernel against the plain
    version of its function on the same operands (the kernels' moments
    and first-pass sums feed both sides, so z, and with it relu's kink,
    is the same on both): {name: (kernel, plain)}, and the kernels'
    outputs of a second run."""
    from rvt_tpu_torch.ops import bn_act as ba

    w, b, eps = bn.weight, bn.bias, bn.eps

    def run():
        run_b = (bn.running_mean.clone(), bn.running_var.clone())
        mom = ba.moments(y)
        out = ba.act_fwd(y, mom, 1, w, b, eps, act, run_b)
        sums, dpar = ba.bwd_sums(y, gr, mom, 1, w, b, eps, act)
        dy = ba.bwd_dy(y, gr, mom, sums, 1, w, b, eps, act)
        return dict(moments=mom, out=out, running_mean=run_b[0],
                    running_var=run_b[1], sums=sums, dparams=dpar, dy=dy)

    with torch.no_grad():
        got, again = run(), run()
        mom, sums = got["moments"], got["sums"]
        run_b = (bn.running_mean.clone(), bn.running_var.clone())
        ref = dict(moments=ba.moments(y, plain=True),
                   out=ba.act_fwd(y, mom, 1, w, b, eps, act, run_b,
                                  plain=True),
                   running_mean=run_b[0], running_var=run_b[1])
        ref["sums"], ref["dparams"] = ba.bwd_sums(y, gr, mom, 1, w, b, eps,
                                                  act, plain=True)
        ref["dy"] = ba.bwd_dy(y, gr, mom, sums, 1, w, b, eps, act,
                              plain=True)
    return {k: (got[k], ref[k]) for k in got}, again


# The kernels against the plain version, each within this share of the
# plain tensor's max |.|: the same f32 arithmetic in another order (the
# moments' and sums' chunked, in-order adds against PyTorch's reductions;
# fma contraction); dy is bf16, where that order moves a rounding by one
# ulp (2^-8 of its value) now and then.
BN_TOL = {"moments": 1e-5, "out": 1e-4, "running_mean": 1e-5,
          "running_var": 1e-5, "sums": 1e-4, "dparams": 1e-4, "dy": 2 ** -7}


@pytest.mark.parametrize("dataset,size", [("gen1", "base"), ("gen1", "small"),
                                          ("gen4", "base")])
def test_bn_act_kernels_at_every_neck_and_head_shape(dev, dataset, size):
    """Train-mode BatchNorm + activation (``csrc/bn_act.cu``) on every
    BaseConv call of the neck and head of gen1 RVT-B, RVT-S and gen4
    RVT-B at the train cells' 48 gathered frames (their layouts and the
    gradients autograd hands over): four launches a call, forward and
    backward against the plain version, the same bits on a second run."""
    from rvt_tpu_torch.ops import bn_act as ba

    calls = bn_act_calls(dataset, size, 48, dev)
    assert len(calls) == {"base": 47, "small": 39}[size]
    layouts = set()
    for y, gr, bn, act in calls:
        layouts.add(y.is_contiguous())
        n = ba.BN_ACT.launches
        pairs, again = bn_act_vs_plain(y, gr, bn, act)
        assert ba.BN_ACT.launches == n + 8  # two runs of four
        for k, (got, ref) in pairs.items():
            assert got.dtype == ref.dtype and got.shape == ref.shape, k
            _rel_close(got, ref, BN_TOL[k])
            assert torch.equal(got, again[k]), k
        assert pairs["dy"][0].stride() == y.stride()
    assert layouts == {True, False}  # both layouts occur


@pytest.mark.parametrize("ydtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["silu", "relu", "lrelu"])
@pytest.mark.parametrize("shape", [(4, 24, 6, 8), (3, 33, 5, 7),
                                   (2, 1000, 1, 3), (48, 512, 8, 10)])
@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_bn_act_kernels_small_and_ragged(dev, layout, shape, act, ydtype):
    """Every activation on both y dtypes and layouts, at shapes that take
    narrow vectors (odd C or S: 1- and 2-element loads), 1,000 channels
    over three elements each, and one chunk a channel; a constant channel
    (E[y^2] - E[y]^2 at or under 0: the variance's gradient is cut) and the
    gradient as a slice of a wider one."""
    fmt = torch.channels_last if layout == "hwc" else torch.contiguous_format
    N, C, H, W = shape
    y = (_randn(dev, N, C, H, W, scale=2.0, dtype=torch.float32) + 0.5)
    y[:, 0] = 3.0
    y = y.to(ydtype).contiguous(memory_format=fmt)
    wide = _randn(dev, N, C + 5, H, W, dtype=torch.float32, seed=1)
    gr = wide.contiguous(memory_format=fmt)[:, 3:3 + C]
    bn = torch.nn.BatchNorm2d(C).to(dev)
    with torch.no_grad():
        bn.weight.copy_(_randn(dev, C, dtype=torch.float32, seed=2) + 1)
        bn.bias.copy_(_randn(dev, C, dtype=torch.float32, seed=3))
    pairs, again = bn_act_vs_plain(y, gr, bn, act)
    for k, (got, ref) in pairs.items():
        _rel_close(got, ref, BN_TOL[k])
        assert torch.equal(got, again[k]), k
    assert torch.isfinite(pairs["dy"][0].float()).all()


def test_bn_act_function_vs_autograd_of_the_torch_ops(dev):
    """The autograd Function (kernels) against PyTorch's autograd over the
    same math in f32 ops (flax's BatchNorm then silu) on one neck shape:
    output, running buffers, and the gradients of y, scale and bias."""
    from rvt_tpu_torch.ops import bn_act as ba

    y = _randn(dev, 48, 128, 32, 40, scale=2.0) + 0.3
    gr = _randn(dev, 48, 128, 32, 40, dtype=torch.float32, seed=1)
    bn = torch.nn.BatchNorm2d(128).to(dev)
    ref_bn = torch.nn.BatchNorm2d(128).to(dev)
    yk = y.clone().requires_grad_()
    out = ba.batch_norm_act_train(yk, bn, "silu")
    out.backward(gr)
    yr = y.clone().requires_grad_()
    yf = yr.float()
    mean, msq = yf.mean((0, 2, 3)), (yf * yf).mean((0, 2, 3))
    var = torch.clamp(msq - mean * mean, min=0.0)
    mul = torch.rsqrt(var + ref_bn.eps) * ref_bn.weight
    ref = torch.nn.functional.silu(
        (yf - mean[:, None, None]) * mul[:, None, None]
        + ref_bn.bias[:, None, None])
    ref.backward(gr)
    with torch.no_grad():
        ref_bn.running_mean.mul_(0.9).add_(0.1 * mean)
        ref_bn.running_var.mul_(0.9).add_(0.1 * var)
    _rel_close(out.detach(), ref.detach(), 1e-4)
    _rel_close(bn.running_mean, ref_bn.running_mean, 1e-5)
    _rel_close(bn.running_var, ref_bn.running_var, 1e-5)
    _rel_close(yk.grad, yr.grad, 2 ** -7)
    _rel_close(bn.weight.grad, ref_bn.weight.grad, 1e-4)
    _rel_close(bn.bias.grad, ref_bn.bias.grad, 1e-4)
