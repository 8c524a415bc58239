"""The CUDA side of the port's kernel wrappers, without a card: the tensors
pretend to live on a CUDA device and the compiled library is replaced by
a stand-in that checks each call against the C signature the library is
loaded with. So the argument marshalling, the operand checks and the
launch counters run here; ``test_torch_cuda.py`` runs the kernels."""
import ctypes

import pytest
import torch

from rvt_tpu_torch.ops import bn_act
from rvt_tpu_torch.ops import fused_attention as fa
from rvt_tpu_torch.ops import fused_scan as fs
from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops import s2d
from rvt_tpu_torch.ops import voxelization as vx


class _FakeLib:
    """Stands in for ``kernels.lib(name)``: checks the launcher's name and
    each argument against ``kernels.SIGNATURES``, keeps the arguments
    (``launches``), returns success."""

    calls = []
    launches = []

    def __init__(self, name):
        self.name = name

    def __getattr__(self, fn):
        argtypes = kernels.SIGNATURES[self.name][fn]

        def launch(*args):
            assert len(args) == len(argtypes), (fn, len(args))
            for a, t in zip(args, argtypes):
                if t is ctypes.c_void_p:
                    assert a is None or isinstance(a, (ctypes.c_void_p, int))
                elif t in (ctypes.c_int, ctypes.c_long):
                    assert type(a) is int, (fn, a)
                else:
                    assert type(a) is float, (fn, a)
            _FakeLib.calls.append(fn)
            _FakeLib.launches.append((fn, args))
            return 0

        return launch


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(kernels, "lib", _FakeLib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for mod in (fa, fs, vx, s2d, bn_act):
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fa, "sm_count", lambda t: 132)
    _FakeLib.calls = []
    _FakeLib.launches = []
    return _FakeLib.calls


def _bf(*shape):
    return torch.randn(shape).to(torch.bfloat16)


def test_wrappers_launch_once_and_count(fake_cuda):
    counters = (fa.LN_ROWS, fa.GEMM_BF16, fa.PARTITION_ATTENTION,
                fs.LSTM_SCAN, vx.STACKED_HISTOGRAM)
    before = [c.launches for c in counters]
    y, yf = fa.ln_rows(torch.randn(40, 64), _bf(64), _bf(64), 1e-5,
                       with_f32=True)
    assert y.dtype == torch.bfloat16 and yf.dtype == torch.float32
    for epi in ("bias", "gelu"):
        assert fa.gemm_bf16(_bf(40, 64), _bf(64, 96), epi,
                            bias=_bf(96)).shape == (40, 96)
    R = torch.zeros(40, 96)
    assert fa.gemm_bf16(_bf(40, 64), _bf(64, 96), "residual", bias=_bf(96),
                        out=R) is R
    o = fa.partition_attention(_bf(2, 16, 20, 192), heads=2, dim_head=32,
                               part=(8, 10), window=False)
    assert o.shape == (2, 16, 20, 64)
    h_seq, hT, cT = fs.fused_lstm_scan(
        torch.randn(3, 2, 4, 5, 64), _bf(128, 256), _bf(256),
        torch.zeros(2, 4, 5, 64), torch.zeros(2, 4, 5, 64))
    assert h_seq.dtype == torch.bfloat16 and hT.shape == (2, 4, 5, 64)
    ev = [torch.zeros(2, 100, dtype=torch.int32) for _ in range(4)]
    hist = vx.stacked_histogram_batched(
        *ev, torch.full((2,), 90, dtype=torch.int32), 10, 24, 32)
    assert hist.dtype == torch.uint8 and hist.shape == (2, 20, 24, 32)
    assert fake_cuda == ["rvt_ln_rows"] + ["rvt_gemm_bf16"] * 3 + [
        "rvt_partition_attention", "rvt_lstm_scan", "rvt_stacked_histogram"]
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 3, 1, 1,
                                                                  1]


def test_wrappers_reject_what_the_kernels_do_not_take(fake_cuda):
    with pytest.raises(ValueError):  # K not a multiple of 8
        fa.gemm_bf16(_bf(40, 12), _bf(12, 96), "bias", bias=_bf(96))
    with pytest.raises(ValueError):  # the residual epilogue adds into out
        fa.gemm_bf16(_bf(40, 64), _bf(64, 96), "residual", bias=_bf(96))
    with pytest.raises(ValueError):  # f32 qkv
        fa.partition_attention(torch.randn(2, 16, 20, 192), heads=2,
                               dim_head=32, part=(8, 10), window=True)
    with pytest.raises(ValueError):  # C = 40: not a multiple of 16
        fs.fused_lstm_scan(torch.randn(3, 2, 4, 5, 40), _bf(80, 160),
                           _bf(160), torch.zeros(2, 4, 5, 40),
                           torch.zeros(2, 4, 5, 40))
    ev = [torch.zeros(2, 100, dtype=torch.int32) for _ in range(3)]
    t64 = torch.zeros(2, 100, dtype=torch.long)
    with pytest.raises(ValueError):  # int64 t
        vx.stacked_histogram_batched(*ev, t64,
                                     torch.full((2,), 90, dtype=torch.int32),
                                     10, 24, 32)
    with pytest.raises(ValueError):  # a cutoff that uint8 cannot hold
        vx.stacked_histogram_batched(*ev, ev[0],
                                     torch.full((2,), 90, dtype=torch.int32),
                                     10, 24, 32, count_cutoff=300)
    assert fake_cuda == []


@pytest.mark.parametrize("layout", ["stored", "contiguous"])
def test_window_s2d_launch_arguments(fake_cuda, layout):
    """``window_s2d``'s launch: the window's shape and element strides (the
    stored buffer's channel-last view, or a contiguous window) and the
    blocked frame reach the C signature, one launch counted; the output is
    the T-major bf16 operand."""
    ev = torch.zeros(2, 3, 20, 240, 304, dtype=torch.uint8).permute(
        0, 1, 3, 4, 2)
    if layout == "contiguous":
        ev = ev.contiguous()
    n = s2d.WINDOW_S2D.launches
    out = s2d.window_s2d(ev, (256, 320))
    assert out.shape == (3, 2, 65, 81, 320) and out.is_contiguous()
    assert out.dtype == torch.bfloat16
    assert fake_cuda == ["rvt_window_s2d"]
    assert s2d.WINDOW_S2D.launches == n + 1
    args = _FakeLib.launches[0][1]
    assert args[2:] == (2, 3, 240, 304, 20) + ev.stride() + (65, 81, 0)


def test_window_s2d_rejects_what_the_kernel_does_not_take(fake_cuda):
    ev = torch.zeros(1, 2, 240, 304, 20, dtype=torch.uint8)
    with pytest.raises(ValueError):  # not uint8
        s2d.window_s2d(ev.float(), (256, 320))
    with pytest.raises(ValueError):  # larger than the model's frame
        s2d.window_s2d(ev, (236, 320))
    with pytest.raises(ValueError):  # a frame not of whole blocks
        s2d.window_s2d(ev, (256, 318))
    with pytest.raises(ValueError):  # more staged rows than a block holds
        s2d.window_s2d(torch.zeros(1, 1, 8, 4000, 20, dtype=torch.uint8),
                       (8, 4000))
    assert fake_cuda == []


def test_stacked_histogram_workspace_and_plan(fake_cuda):
    """The voxelizer's launch: the plan of ``histogram_plan`` and the
    per-device workspace (the bucket kernel's (offset, count) table and
    its 16-bit chunk array) kept from call to call and grown only when a
    call needs more; no scratch the size of the output."""
    ev = [torch.zeros(2, 100, dtype=torch.int32) for _ in range(4)]
    counts = torch.full((2,), 90, dtype=torch.int32)
    vx._HIST_WS.clear()
    for _ in range(2):
        vx.stacked_histogram_batched(*ev, counts, 10, 24, 32)
    (_, a1), (_, a2) = _FakeLib.launches
    # the same workspace both calls
    assert [a.value for a in a1[5:7]] == [a.value for a in a2[5:7]]
    plan = vx.histogram_plan(2, 100, 10, 24, 32)
    assert a1[8:] == (2, 100, 10, 24, 32, 255, plan.tile_bins, plan.tiles,
                      plan.span, plan.event_blocks, 0)
    table, chunk = vx._HIST_WS[-1]
    assert [a1[5].value, a1[6].value] == [table.data_ptr(), chunk.data_ptr()]
    assert table.dtype == torch.int32 and chunk.element_size() == 2
    assert table.numel() >= 2 * 2 * plan.table_entries
    assert chunk.numel() >= 2 * plan.chunk_entries >= 200
    # at the raw cell's shape the workspace needs less than the uint8
    # output itself (the old design's int32 scratch was 4x the output)
    g1 = vx.histogram_plan(8, 32768, 10, 240, 304)
    assert 8 * (8 * g1.table_entries + 2 * g1.chunk_entries) < g1.total
    big = [torch.zeros(2, 300_000, dtype=torch.int32) for _ in range(4)]
    vx.stacked_histogram_batched(*big, counts, 10, 720, 1280)
    bplan = vx.histogram_plan(2, 300_000, 10, 720, 1280)
    table, chunk = vx._HIST_WS[-1]
    assert table.numel() >= 2 * 2 * bplan.table_entries
    assert chunk.numel() >= 2 * bplan.chunk_entries >= 600_000


def test_plain_histogram_takes_no_events():
    """The plain version (the card's reference) with N = 0 and with
    counts = 0: all zeros."""
    ev = [torch.zeros(2, 0, dtype=torch.int32) for _ in range(4)]
    out = vx.stacked_histogram_plain(*ev, torch.full((2,), 3, dtype=torch.int32),
                                     10, 7, 9)
    assert out.shape == (2, 20, 7, 9) and int(out.max()) == 0
    ev = [torch.ones(2, 5, dtype=torch.int32) for _ in range(4)]
    out = vx.stacked_histogram_plain(*ev, torch.zeros(2, dtype=torch.int32),
                                     10, 7, 9)
    assert int(out.max()) == 0


@pytest.mark.parametrize("shape", [(8, 32768, 10, 240, 304),
                                   (8, 32768, 10, 360, 640),
                                   (2, 100, 10, 720, 1280),
                                   (3, 0, 10, 7, 9), (1, 5, 1, 1, 1)])
def test_histogram_plan_tiles_the_output_once(shape):
    """The tiles cover the flat output once, each within a quarter of an
    SM's shared memory, 16-byte aligned, in-tile indices in 16 bits; a
    lane's events touch at most ``span`` tiles; the bucket blocks hold
    every event."""
    B, N, bins, H, W = shape
    plan = vx.histogram_plan(B, N, bins, H, W)
    plane = 2 * bins * H * W
    assert plan.total == B * plane
    assert plan.tile_bins % 16 == 0 and plan.tile_bins <= 2 ** 16
    # 16-bit counters (or 32-bit ones for half a tile): 48 KB, four
    # blocks in an SM's 228 KB
    assert 4 * (plan.tile_bins * 2 + 1024) <= 228 * 1024
    assert (plan.tiles - 1) * plan.tile_bins < plan.total <= (
        plan.tiles * plan.tile_bins)
    for b in range(B):
        first = b * plane // plan.tile_bins
        last = ((b + 1) * plane - 1) // plan.tile_bins
        assert last - first + 1 <= plan.span <= vx.HIST_MAX_SPAN
    assert plan.event_blocks * vx.HIST_EVENTS_PER_BLOCK >= N
    assert plan.event_blocks >= 1 and plan.launches == 2
    assert plan.chunk_entries >= N
    assert plan.table_entries == plan.event_blocks * plan.span


def test_train_wrappers_launch_once_and_count(fake_cuda):
    """The training kernels' wrappers: one launch each (plus the in-order
    sum of their partials, ``rvt_sum_parts``, after K2's gelu backward, K5,
    K6 and K8; ``col_sum`` and ``layer_scale_bwd`` finish their sums in
    their own launch), counted where they launch."""
    counters = (fa.GEMM_BF16, fa.LN_ROWS_BWD, fa.GEMM_BF16_WGRAD,
                fa.PARTITION_ATTENTION_BWD, fa.TRAIN_REDUCE, fs.LSTM_SCAN,
                fs.LSTM_SCAN_BWD)
    before = [c.launches for c in counters]
    a, w = _bf(40, 64), _bf(64, 96)
    g, h1 = fa.gemm_bf16(a, w, "gelu", bias=_bf(96), want_aux=True)
    assert g.shape == h1.shape == (40, 96) and h1.dtype == torch.bfloat16
    R = torch.zeros(40, 96)
    out = fa.gemm_bf16(a, w, "residual_ls", bias=_bf(96),
                       gamma=torch.ones(96), res_in=R, out=R)
    assert out is R
    d, db = fa.gemm_bf16(_bf(40, 64), _bf(96, 64), "rt_gelu_bwd", aux=h1)
    assert d.dtype == torch.bfloat16 and db.shape == (96,)
    assert fa.gemm_bf16(_bf(40, 96), w, "rt_f32").dtype == torch.float32
    dx, ds, dbias = fa.ln_rows_bwd(torch.randn(40, 64), torch.randn(40, 64),
                                   _bf(64), 1e-5)
    assert dx.dtype == torch.bfloat16 and ds.shape == dbias.shape == (64,)
    assert fa.gemm_bf16_wgrad(_bf(5000, 64), _bf(5000, 96)).shape == (64, 96)
    dqkv = fa.partition_attention_bwd(_bf(2, 16, 20, 192), _bf(2, 16, 20, 64),
                                      heads=2, dim_head=32, part=(8, 10),
                                      window=True)
    assert dqkv.shape == (2, 16, 20, 192)
    dm, dlb, dg = fa.layer_scale_bwd(torch.randn(40, 64), _bf(40, 64),
                                     torch.ones(64))
    assert dm.dtype == torch.bfloat16 and dg.shape == (64,)
    assert fa.col_sum(_bf(40, 64)).shape == (64,)
    T, B, H, W, C = 3, 2, 4, 5, 64
    z = torch.zeros(B, H, W, C)
    h_seq, c_seq, hT, cT = fs.fused_lstm_scan(
        torch.randn(T, B, H, W, C), _bf(2 * C, 4 * C), _bf(4 * C), z, z,
        with_c_seq=True)
    assert c_seq.dtype == torch.float32 and c_seq.shape == (T, B, H, W, C)
    dxs, dW, dlb, dh0, dc0 = fs.lstm_scan_bwd(
        torch.randn(T, B, H, W, C), _bf(2 * C, 4 * C), _bf(4 * C), z, z,
        _bf(T, B, H, W, C), torch.randn(T, B, H, W, C), _bf(T, B, H, W, C),
        z, z)
    assert dxs.dtype == torch.float32 and dh0.shape == (B, H, W, C)
    assert fake_cuda == (
        ["rvt_gemm_bf16"] * 2 + ["rvt_gemm_bf16", "rvt_sum_parts"]
        + ["rvt_gemm_bf16"] + ["rvt_ln_rows_bwd", "rvt_sum_parts"]
        + ["rvt_gemm_bf16_wgrad", "rvt_sum_parts"]
        + ["rvt_partition_attention_bwd"] + ["rvt_ls_bwd"]
        + ["rvt_colsum"] + ["rvt_lstm_scan"]
        + ["rvt_lstm_bwd_pack", "rvt_gemm_bf16", "rvt_lstm_bwd_scan",
           "rvt_gemm_bf16", "rvt_gemm_bf16_wgrad", "rvt_sum_parts",
           "rvt_sum_parts"])
    # K8's two K2 products count on K8's counter, not on K2's
    assert fs.lstm_scan_bwd_launches(T, B * H * W, C) == 4
    assert [c.launches - b for c, b in zip(counters, before)] == [
        4, 1, 2, 1, 7, 1, 4]


def test_train_wrappers_reject_what_the_kernels_do_not_take(fake_cuda):
    with pytest.raises(ValueError):  # C = 160: five values a lane
        fa.ln_rows_bwd(torch.randn(40, 160), torch.randn(40, 160), _bf(160),
                       1e-5)
    with pytest.raises(ValueError):  # 8 x 20 = 160 tokens > 128
        fa.partition_attention_bwd(_bf(2, 16, 20, 192), _bf(2, 16, 20, 64),
                                   heads=2, dim_head=32, part=(8, 20),
                                   window=False)
    with pytest.raises(ValueError):  # rt_gelu_bwd needs the bf16 h1
        fa.gemm_bf16(_bf(40, 96), _bf(64, 96), "rt_gelu_bwd",
                     aux=torch.randn(40, 64))
    with pytest.raises(ValueError):  # f32 operands
        fa.gemm_bf16_wgrad(torch.randn(64, 8), torch.randn(64, 8))
    assert fake_cuda == []


# gen1 RVT-B's stages (H, W, C) and the frames one launch covers on each
# path: the eval window and the train step (T * B = 168), the raw and the
# per-step train paths (B = 8), and the per-step path's tiny case.
_STAGES = ((64, 80, 64), (32, 40, 128), (16, 20, 256), (8, 10, 512))
_PATH_FRAMES = {"eval/train": 168, "raw/per-step": 8, "one frame": 1}


def _k6_shapes(C):
    """(Ka, Nb) of every weight gradient of a stage: qkv, proj, fc1, fc2,
    the LSTM."""
    return ((C, 3 * C), (C, C), (C, 4 * C), (4 * C, C), (2 * C, 4 * C))


@pytest.mark.parametrize("path", list(_PATH_FRAMES))
@pytest.mark.parametrize("stage", range(4))
def test_wgrad_split_plan(path, stage):
    """K6's row splits at every path's shapes: whole 64-row k-tiles, every
    row in exactly one split (the launcher refuses anything else), at most
    one (split, tile) unit per SM, and as many splits as fill them."""
    H, W, C = _STAGES[stage]
    M = _PATH_FRAMES[path] * H * W
    sms = 132
    for Ka, Nb in _k6_shapes(C):
        splits, rps = fa.wgrad_splits(M, Ka, Nb, sms)
        bm, bn = fa.wgrad_tile(Ka, Nb)
        tiles = -(-Ka // bm) * -(-Nb // bn)
        assert rps % 64 == 0 and rps > 0
        assert (splits - 1) * rps < M <= splits * rps
        assert splits == 1 or splits * tiles <= sms
        # as many splits as fill the SMs, fewer only where the rows (whole
        # 64-row k-tiles) run out
        wanted = max(1, min(sms // tiles, -(-M // 64)))
        assert splits <= wanted and rps <= 64 * -(-M // (64 * wanted)) + 64


@pytest.mark.parametrize("ka_nb, tile", [((64, 192), (64, 256)),
                                         ((256, 64), (128, 64)),
                                         ((128, 256), (128, 256)),
                                         ((64, 64), (64, 64)),
                                         ((1024, 2048), (128, 256)),
                                         ((8, 40), (64, 64)),
                                         ((512, 128), (128, 128))])
def test_wgrad_tile(ka_nb, tile):
    """The tile csrc/gemm_bf16_wgrad.cu picks: 64 rows up to Ka = 64, else
    128; 64, 128 or 256 columns."""
    assert fa.wgrad_tile(*ka_nb) == tile


@pytest.mark.parametrize("M", [1, 63, 64, 65, 130, 640, 10240])
def test_gelu_bwd_partials_reach_the_launcher(fake_cuda, M):
    """rt_gelu_bwd's column-sum partials: one row per 64 rows of a, the
    count passed to the launcher (which refuses any other), then summed in
    order by one rvt_sum_parts."""
    N = 48
    assert fa.gemm_part_rows(M) == -(-M // 64)
    d, db = fa.gemm_bf16(_bf(M, 40), _bf(N, 40), "rt_gelu_bwd",
                         aux=_bf(M, N))
    assert d.shape == (M, N) and db.shape == (N,)
    (fn, args), (fn2, args2) = _FakeLib.launches
    assert fn == "rvt_gemm_bf16" and fn2 == "rvt_sum_parts"
    part_rows, m, n, k, epi = args[8:13]
    assert (part_rows, m, n, k, epi) == (-(-M // 64), M, N, 40, 7)
    assert args2[2] == part_rows and args2[3] == N


def test_gemm_launch_arguments(fake_cuda):
    """The launcher's arguments: M, N, K, the epilogue's number, 0 partial
    rows where no column sums are made; W [N, K] for the rt_ modes."""
    fa.gemm_bf16(_bf(130, 64), _bf(64, 96), "bias", bias=_bf(96))
    fa.gemm_bf16(_bf(130, 96), _bf(64, 96), "rt_f32")
    (_, a1), (_, a2) = _FakeLib.launches
    assert a1[8:13] == (0, 130, 96, 64, 0)
    assert a2[8:13] == (0, 130, 64, 96, 4)
    # the plan query: M, N, K, the epilogue's number, int[4] out
    assert kernels.SIGNATURES["gemm_bf16"]["rvt_gemm_bf16_plan"] == (
        (ctypes.c_int,) * 4 + (ctypes.c_void_p,))


# K2's schedule (``gemm_schedule``, the mirror of csrc/gemm_bf16.cu's
# ``schedule``) at every stage shape of the steps the benchmark runs, on
# 132 SMs: the products that take ping-pong, stage by stage ("-": none).
# Each config's stages (H, W, C) and the frames a launch covers: eval and
# train T * B, raw B.
_SCHEDULE_STAGES = {
    "rvtb_gen1": ((64, 80, 64), (32, 40, 128), (16, 20, 256), (8, 10, 512)),
    "rvts_gen1": ((64, 80, 48), (32, 40, 96), (16, 20, 192), (8, 10, 384)),
    "rvtb_gen4": ((96, 160, 64), (48, 80, 128), (24, 40, 256),
                  (12, 20, 512))}
_EVAL_PRODUCTS = (("qkv", "bias", 1, 3), ("proj", "residual", 1, 1),
                  ("fc1", "gelu", 1, 4), ("fc2", "residual", 4, 1))
_TRAIN_PRODUCTS = (("qkv", "bias", 1, 3), ("proj", "residual_ls", 1, 1),
                   ("fc1", "gelu", 1, 4), ("fc2", "residual_ls", 4, 1),
                   ("m", "bias", 4, 1), ("dg", "rt_gelu_bwd", 1, 4),
                   ("dy", "rt_f32", 4, 1), ("dattn", "rt_bf16", 1, 1),
                   ("dxa", "rt_f32", 3, 1), ("dxbf", "rt_acc", 3, 1))
_TRAIN_PP = ["qkv proj fc2 dy dattn dxa dxbf"] * 2 + ["proj fc2 dy dxa dxbf",
                                                      "proj"]


@pytest.mark.parametrize("config, path, frames, pingpong", [
    ("rvtb_gen1", "eval", 168, ["qkv proj fc2"] * 2 + ["proj fc2", "proj"]),
    ("rvtb_gen1", "train", 168, _TRAIN_PP),
    ("rvtb_gen1", "raw", 8, ["qkv proj fc2", "qkv", "-", "-"]),
    ("rvts_gen1", "eval", 168, ["qkv proj fc2"] * 2 + ["proj fc2", "proj"]),
    ("rvts_gen1", "train", 168, _TRAIN_PP),
    ("rvts_gen1", "raw", 8, ["qkv proj fc2"] * 2 + ["-", "-"]),
    ("rvtb_gen4", "train", 60, _TRAIN_PP)])
def test_gemm_schedule_at_the_stage_shapes(config, path, frames, pingpong):
    """Which products of each stage take the ping-pong schedule: the
    residual and data-gradient products (f32 epilogues) wherever every
    block gets two 64-row tiles and K <= 1024 (not stage 4's 4C-deep
    ones), qkv and dattn only at K <= 128; never fc1 or the gelu
    backward. The others keep the cooperative tiles by the old rule."""
    products = _TRAIN_PRODUCTS if path == "train" else _EVAL_PRODUCTS
    sms = 132
    for (H, W, C), want in zip(_SCHEDULE_STAGES[config], pingpong):
        M = frames * H * W
        took = []
        for label, epi, k, n in products:
            K, N = k * C, n * C
            s = fa.gemm_schedule(M, N, K, epi, sms)
            bn = 128 if N % 128 == 0 else 64
            assert s.cols == bn
            if s.pingpong:
                took.append(label)
                assert (s.rows, s.warpgroups) == (64, 2)
                assert -(-M // 64) * -(-N // bn) >= 2 * sms
            else:
                rows = (64 if -(-M // 128) * -(-N // bn) < sms
                        else 192 if N >= 2 * K else 128)
                assert (s.rows, s.warpgroups) == (rows, rows // 64)
        assert (" ".join(took) or "-") == want, (H, W, C)


@pytest.mark.parametrize("M, N, K, epilogue, pingpong", [
    (64 * 264, 64, 64, "residual", True),      # two tiles a block
    (64 * 263, 64, 64, "residual", False),     # not quite
    (64 * 263 + 1, 64, 64, "rt_acc", True),    # a ragged 264th tile
    (640 * 64, 64, 1024, "residual_ls", True),
    (640 * 64, 64, 1032, "rt_f32", False),     # a mainloop past 16 k-tiles
    (640 * 64, 192, 128, "bias", True),
    (640 * 64, 192, 136, "bias", False),
    (640 * 64, 64, 128, "rt_bf16", True),
    (640 * 64, 256, 64, "gelu", False),        # tanhf-bound: cooperative
    (640 * 64, 256, 64, "rt_gelu_bwd", False)])
def test_gemm_schedule_rule(M, N, K, epilogue, pingpong):
    assert fa.gemm_schedule(M, N, K, epilogue, 132).pingpong == pingpong


def test_gemm_launch_tallies_its_schedule(fake_cuda):
    """Each K2 launch adds one to the tally of the schedule it took,
    whichever counter its launch is credited to; the tallies are not
    counters, so the sum over ``COUNTERS`` (``hand_launches``) moves by
    the launches alone."""
    tallies = (fa.GEMM_BF16_PINGPONG, fa.GEMM_BF16_COOPERATIVE)
    assert all(t.tally and t in kernels.TALLIES
               and t not in kernels.COUNTERS for t in tallies)
    before = [t.launches for t in tallies]
    n_k2, n_k4 = fa.GEMM_BF16.launches, fs.LSTM_SCAN.launches
    total = sum(c.launches for c in kernels.COUNTERS)
    M = 64 * 264
    R = torch.zeros(M, 64)
    fa.gemm_bf16(_bf(M, 64), _bf(64, 64), "residual", bias=_bf(64), out=R)
    fa.gemm_bf16(_bf(M, 64), _bf(64, 256), "gelu", bias=_bf(256))
    fa.gemm_bf16(_bf(M, 64), _bf(256, 64), "rt_f32", counter=fs.LSTM_SCAN)
    assert [t.launches - b for t, b in zip(tallies, before)] == [2, 1]
    assert fa.GEMM_BF16.launches == n_k2 + 2
    assert fs.LSTM_SCAN.launches == n_k4 + 1
    assert sum(c.launches for c in kernels.COUNTERS) == total + 3


def test_replays_credit_the_tallies_outside_the_launches():
    """A captured step credits every counter and tally its capture moved,
    at every replay, and counts only the counters as its launches."""
    from rvt_tpu_torch.training import graphs

    g = graphs._Graph(None, [], None, {fa.GEMM_BF16: 3, fs.LSTM_SCAN: 1,
                                       fa.GEMM_BF16_PINGPONG: 2,
                                       fa.GEMM_BF16_COOPERATIVE: 2}, None)
    assert g.launches == 4
    assert graphs._launches() == sum(c.launches for c in kernels.COUNTERS)


def test_stage_scan_hands_k4_the_pairs_bf16_copy(fake_cuda):
    """On the kernel path a wide stage's last product (the grid block's
    fc2, "residual") also writes bf16(R) into its aux output, and K4's
    input product reads that copy instead of casting R again."""
    T, B, H, W, C = 2, 1, 8, 10, 96
    prm = {k: _bf(*shape) for k, shape in (
        ("qkv_w", (C, 3 * C)), ("qkv_b", (3 * C,)), ("proj_w", (C, C)),
        ("proj_b", (C,)), ("ln2_s", (C,)), ("ln2_b", (C,)),
        ("fc1_w", (C, 4 * C)), ("fc1_b", (4 * C,)), ("fc2_w", (4 * C, C)),
        ("fc2_b", (C,)))}
    grid = dict(prm, ln1_s=_bf(C), ln1_b=_bf(C))
    fs.fused_stage_scan(torch.randn(T, B, H, W, C).bfloat16(), prm, grid,
                        _bf(2 * C, 4 * C), _bf(4 * C),
                        torch.zeros(B, H, W, C), torch.zeros(B, H, W, C),
                        heads=4, dim_head=24, part=(8, 10), eps=1e-5,
                        ds_ln_params=(_bf(C), _bf(C)))
    gemms = [a for fn, a in _FakeLib.launches if fn == "rvt_gemm_bf16"]
    fc2, product = gemms[-2], gemms[-1]
    assert fc2[12] == fa.EPILOGUES["residual"] and fc2[5] is not None
    assert product[12] == fa.EPILOGUES["rt_f32"]
    assert product[0].value == fc2[5].value  # A of the product = the copy
    assert [fn for fn, _ in _FakeLib.launches][-2:] == ["rvt_gemm_bf16",
                                                        "rvt_lstm_scan"]


@pytest.mark.parametrize("M", [1, 127, 129, 5000])
def test_wgrad_launch_arguments(fake_cuda, M):
    """K6's launcher gets the planned splits and rows per split; one
    split's partial is returned as it is, more are summed in order."""
    a, b = _bf(M, 40), _bf(M, 48)
    assert fa.gemm_bf16_wgrad(a, b).shape == (40, 48)
    splits, rps = fa.wgrad_splits(M, 40, 48, 132)
    fn, args = _FakeLib.launches[0]
    assert fn == "rvt_gemm_bf16_wgrad" and args[3:8] == (M, 40, 48, splits,
                                                          rps)
    assert fake_cuda[1:] == ([] if splits == 1 else ["rvt_sum_parts"])


@pytest.mark.parametrize("hoist_bytes,chunks", [(512 * 2 ** 20, 1),
                                                (2 * 20 * 384 * 4, 2)])
def test_lstm_scan_hoists_the_input_product(fake_cuda, monkeypatch,
                                            hoist_bytes, chunks):
    """Wider than 64 channels K4 runs x . W_x first (K2's rt_f32 epilogue
    on the bf16 x and W_x^T, counted on K4's counter, not K2's), then the
    recurrent kernel on its f32 output; a buffer bound splits the steps
    into chunks whose carries chain through h_T / c_T."""
    monkeypatch.setattr(fs, "_HOIST_BYTES", hoist_bytes)
    T, B, H, W, C = 3, 2, 2, 5, 96
    before = fs.LSTM_SCAN.launches, fa.GEMM_BF16.launches
    h_seq, hT, cT = fs.fused_lstm_scan(
        torch.randn(T, B, H, W, C), _bf(2 * C, 4 * C), _bf(4 * C),
        torch.zeros(B, H, W, C), torch.zeros(B, H, W, C))
    assert h_seq.shape == (T, B, H, W, C) and hT.dtype == torch.float32
    assert fake_cuda == ["rvt_gemm_bf16", "rvt_lstm_scan"] * chunks
    assert fs.lstm_scan_launches(T, B * H * W, C) == 2 * chunks
    assert (fs.LSTM_SCAN.launches - before[0],
            fa.GEMM_BF16.launches - before[1]) == (2 * chunks, 0)
    scans = [args for fn, args in _FakeLib.launches if fn == "rvt_lstm_scan"]
    gemms = [args for fn, args in _FakeLib.launches if fn == "rvt_gemm_bf16"]
    assert all(a[12] == fa.EPILOGUES["rt_f32"] for a in gemms)
    assert [a[11] for a in scans] == ([2, 1] if chunks == 2 else [3])
    assert all(a[2] is not None and a[0] is None for a in scans)
    if chunks == 2:  # the second chunk starts from the first one's h_T, c_T
        assert scans[1][5].value == scans[0][9].value
        assert scans[1][6].value == scans[0][10].value


@pytest.mark.parametrize("C", [48, 96, 192, 384])
def test_ln_rows_bwd_takes_every_preset_width(fake_cuda, C):
    """K5 takes the small presets' widths (ceil(C / 32) values a lane,
    masked past C): one launch, then the in-order sum of its partials."""
    dx, ds, db = fa.ln_rows_bwd(torch.randn(40, C), torch.randn(40, C),
                                _bf(C), 1e-5, dres=torch.zeros(40, C))
    assert dx.shape == (40, C) and ds.shape == db.shape == (C,)
    assert fake_cuda == ["rvt_ln_rows_bwd", "rvt_sum_parts"]
    assert _FakeLib.launches[0][1][9] == C


@pytest.mark.parametrize("dim_head,part,C", [(24, (6, 10), 96),
                                             (24, (8, 10), 48),
                                             (32, (6, 10), 128)])
def test_partition_attention_bwd_takes_the_small_presets(fake_cuda,
                                                         dim_head, part, C):
    """K7 takes dh 24 and the (6, 10) partition: one launch with the
    head width and the partition passed to the launcher."""
    H, W = 2 * part[0], 2 * part[1]
    dqkv = fa.partition_attention_bwd(_bf(2, H, W, 3 * C), _bf(2, H, W, C),
                                      heads=C // dim_head, dim_head=dim_head,
                                      part=part, window=False)
    assert dqkv.shape == (2, H, W, 3 * C)
    (fn, args), = _FakeLib.launches
    assert fn == "rvt_partition_attention_bwd"
    assert args[3:11] == (2, H, W, C, dim_head, part[0], part[1], 0)


def _k8_args(T, B, H, W, C):
    z = torch.zeros(B, H, W, C)
    return (torch.randn(T, B, H, W, C), _bf(2 * C, 4 * C), _bf(4 * C), z, z,
            _bf(T, B, H, W, C), torch.randn(T, B, H, W, C),
            _bf(T, B, H, W, C), z, z)


@pytest.mark.parametrize("hoist_bytes,chunks", [(512 * 2 ** 20, 1),
                                                (2 * 20 * 96 * 4 * 2, 2)])
def test_lstm_scan_bwd_launch_sequence(fake_cuda, monkeypatch, hoist_bytes,
                                       chunks):
    """K8 over T > 1 steps: the pack of xh, per chunk of steps (in reverse
    time) K2's "bias" product for the gates and the scan, then one K2
    "rt_f32" product for dx over W_x = w[:C]; every launch counts on
    LSTM_SCAN_BWD, none on K2's counter. Chunks chain the (dh, dc) carry
    and write their own rows of the db partials."""
    monkeypatch.setattr(fs, "_HOIST_BYTES", hoist_bytes)
    T, B, H, W, C = 3, 2, 2, 5, 96
    rows = B * H * W
    args = _k8_args(T, B, H, W, C)
    before = fs.LSTM_SCAN_BWD.launches, fa.GEMM_BF16.launches
    dx, dmix, xh, part, dh0, dc0 = fs.lstm_scan_bwd_launch(*args)
    assert dx.shape == (T, B, H, W, C) and dx.dtype == torch.float32
    assert dmix.shape == (T * rows, 4 * C) and xh.shape == (T * rows, 2 * C)
    assert part.shape == (chunks * -(-rows // fs._PT), 4 * C)
    assert fake_cuda == (["rvt_lstm_bwd_pack"]
                         + ["rvt_gemm_bf16", "rvt_lstm_bwd_scan"] * chunks
                         + ["rvt_gemm_bf16"])
    assert fs.lstm_scan_bwd_launches(T, rows, C) == 2 + 2 * chunks
    assert (fs.LSTM_SCAN_BWD.launches - before[0],
            fa.GEMM_BF16.launches - before[1]) == (2 + 2 * chunks, 0)
    gemms = [a for fn, a in _FakeLib.launches if fn == "rvt_gemm_bf16"]
    scans = [a for fn, a in _FakeLib.launches if fn == "rvt_lstm_bwd_scan"]
    assert [a[12] for a in gemms] == ([fa.EPILOGUES["bias"]] * chunks
                                      + [fa.EPILOGUES["rt_f32"]])
    # the gates' products read xh and the bias; dx's reads dmix and W_x
    assert all(a[0].value >= xh.data_ptr() and a[2] is not None
               for a in gemms[:-1])
    assert gemms[-1][0].value == dmix.data_ptr()
    assert gemms[-1][1].value == args[1].data_ptr()
    assert gemms[-1][9:12] == (T * rows, C, 4 * C)
    # reverse time: (t0, t1) per chunk, product on, the carry chained
    assert [tuple(a[11:13]) for a in scans] == (
        [(0, 3)] if chunks == 1 else [(1, 3), (0, 1)])
    assert all(a[15] == 1 and a[13:15] == (rows, C) for a in scans)
    assert scans[0][5].value == args[8].data_ptr()  # dh_in = dhT
    if chunks == 2:
        assert scans[1][5].value == scans[0][9].value  # dh_out -> dh_in
        assert scans[1][6].value == scans[0][10].value
        assert scans[1][8].value == scans[0][8].value + part[0].numel() * 4 \
            * -(-rows // fs._PT)
    assert dh0.data_ptr() == scans[-1][9].value
    assert dc0.data_ptr() == scans[-1][10].value


def test_lstm_scan_bwd_at_one_step(fake_cuda):
    """K8 at T = 1 (the per-step path) has no recurrence: pack, the gates,
    the cell (no product, no dh carry out), then one K2 product over the
    whole W gives dx and dh_0 together as column views."""
    B, H, W, C = 2, 2, 5, 64
    rows = B * H * W
    before = fs.LSTM_SCAN_BWD.launches, fa.GEMM_BF16.launches
    dx, dmix, xh, part, dh0, dc0 = fs.lstm_scan_bwd_launch(
        *_k8_args(1, B, H, W, C))
    assert fake_cuda == ["rvt_lstm_bwd_pack", "rvt_gemm_bf16",
                         "rvt_lstm_bwd_scan", "rvt_gemm_bf16"]
    assert fs.lstm_scan_bwd_launches(1, rows, C) == 4
    assert (fs.LSTM_SCAN_BWD.launches - before[0],
            fa.GEMM_BF16.launches - before[1]) == (4, 0)
    (_, pack), (_, mix), (_, scan), (_, dxh) = _FakeLib.launches
    assert mix[12] == fa.EPILOGUES["bias"]
    assert dxh[12] == fa.EPILOGUES["rt_f32"] and dxh[9:12] == (rows, 2 * C,
                                                               4 * C)
    assert scan[11:16] == (0, 1, rows, C, 0) and scan[9] is None
    assert dx.shape == (1, B, H, W, C) and dh0.shape == (B, H, W, C)
    assert dh0.data_ptr() == dx.data_ptr() + C * 4  # columns C: of dxh
    assert dc0.data_ptr() == scan[10].value


def _bn_operands(layout, C=24, wide=48):
    """y [4, C, 6, 8] bf16 in ``layout``; its gradient as the channel
    slice of a wider f32 tensor in the same layout (a concatenation's
    backward hands a BaseConv such a slice)."""
    fmt = (torch.channels_last if layout == "hwc"
           else torch.contiguous_format)
    y = _bf(4, C, 6, 8).contiguous(memory_format=fmt)
    g = torch.randn(4, wide, 6, 8).contiguous(memory_format=fmt)[:, :C]
    return y, g


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_bn_act_launch_arguments(fake_cuda, layout):
    """The four launches of a train-mode BatchNorm + activation, forward
    and backward through the autograd Function, each counted: the shape,
    the 16-byte vector, ``bn_plan``'s plan, and the gradient read in place
    as a slice (its sample or row stride) rather than copied."""
    y, g = _bn_operands(layout)
    bn = torch.nn.BatchNorm2d(24)
    n = bn_act.BN_ACT.launches
    out = bn_act.batch_norm_act_train(y.requires_grad_(), bn, "lrelu")
    assert out.dtype == torch.float32 and out.stride() == y.stride()
    out.backward(g)
    assert y.grad.dtype == torch.bfloat16 and y.grad.stride() == y.stride()
    assert fake_cuda == ["rvt_bn_moments", "rvt_bn_act_fwd",
                         "rvt_bn_act_bwd_sums", "rvt_bn_act_bwd_dy"]
    assert bn_act.BN_ACT.launches == n + 4
    chw = layout == "chw"
    shape = (int(chw), 4, 24, 48, 8)
    plan = tuple(bn_act.bn_plan(chw, 4, 24, 48, 8, bn_act._MOMENT_BLOCKS))
    (_, mom), (_, fwd), (_, sums), (_, dy) = _FakeLib.launches
    assert mom[1] == 0 and mom[3:11] == shape + plan
    plan = tuple(bn_act.bn_plan(chw, 4, 24, 48, 8, bn_act._SUM_BLOCKS))
    # grid: 4 * 24 * 48 / 8 vectors, 256 a block
    assert fwd[8:14] == shape + (3,) and fwd[14:19] == (1.0, 1e-5, 0.9,
                                                        1 - 0.9, 2)
    stride = 48 * 48 if chw else 48
    assert sums[3] == stride and sums[9:17] == shape + plan
    assert dy[3] == stride and dy[9:14] == shape
    # this rank's scale and bias gradients come from the first pass
    assert bn.weight.grad.shape == bn.bias.grad.shape == (24,)


def test_bn_act_copies_a_gradient_in_another_layout(fake_cuda):
    """A gradient in the other layout than y's (the first neck conv's
    channels_last output, summed in NCHW by autograd) is copied into y's;
    the kernels never read a layout they do not walk."""
    y, _ = _bn_operands("hwc")
    g = torch.randn(4, 24, 6, 8)
    mom, w = torch.zeros(2, 24), torch.ones(24)
    sums, _ = bn_act.bwd_sums(y, g, mom, 1, w, w, 1e-5, "silu")
    (_, args), = _FakeLib.launches
    assert args[3] == 24 and args[9] == 0  # row stride C, the HWC walk


@pytest.mark.parametrize("ncs", [(48, 64, 1280), (48, 512, 80),
                                 (48, 128, 3840), (4, 24, 6), (1, 1000, 1),
                                 (48, 256, 80), (4, 24, 48), (2, 3, 35)])
@pytest.mark.parametrize("chw", [True, False])
def test_bn_plan_covers_each_channel_once(ncs, chw):
    """Every chunk holds elements and together they hold each channel's
    once; at most 32 chunks, and no more blocks than asked for where a
    block a channel (or tile) fits; HWC tiles of a power of two up to 32
    channel vectors cover the channels."""
    N, C, S = ncs
    vec = next(v for v in (8, 4, 2, 1) if (S if chw else C) % v == 0)
    for blocks in (bn_act._MOMENT_BLOCKS, bn_act._SUM_BLOCKS):
        chunks, rows, tx = bn_act.bn_plan(chw, N, C, S, vec, blocks)
        n = N * S // vec if chw else N * S
        assert 1 <= chunks <= 32 and (chunks - 1) * rows < n <= chunks * rows
        groups = C if chw else -(-(C // vec) // tx)
        assert chunks == 1 or chunks * groups <= blocks
    if chw:
        assert tx == 1
    else:
        assert tx & (tx - 1) == 0 and tx <= 32
        assert -(-(C // vec) // tx) * tx * vec >= C


def test_bn_act_rejects_what_the_kernels_do_not_take(fake_cuda):
    y, g = _bn_operands("chw")
    mom, w = torch.zeros(2, 24), torch.ones(24)
    with pytest.raises(ValueError):  # neither NCHW nor channels_last
        bn_act.moments(y.transpose(2, 3))
    with pytest.raises(ValueError):  # bf16 scale
        bn_act.act_fwd(y, mom, 1, w.bfloat16(), w, 1e-5, "silu")
    with pytest.raises(ValueError):  # a bf16 gradient
        bn_act.bwd_dy(y, g.bfloat16(), mom, mom, 1, w, w, 1e-5, "silu")
    with pytest.raises(ValueError):  # more channels than tickets
        bn_act.moments(_bf(2, 2048, 2, 2))
    with pytest.raises(NotImplementedError):
        bn_act.batch_norm_act_train(y, torch.nn.BatchNorm2d(24), "gelu")
    assert fake_cuda == []
