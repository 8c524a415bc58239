"""The CUDA side of the port's kernel wrappers, without a card: the tensors
pretend to live on a CUDA device and the compiled library is replaced by
a stand-in that checks each call against the C signature the library is
loaded with. So the argument marshalling, the operand checks and the
launch counters run here; ``test_torch_cuda.py`` runs the kernels."""
import ctypes

import pytest
import torch

from rvt_tpu_torch.ops import fused_attention as fa
from rvt_tpu_torch.ops import fused_scan as fs
from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops import voxelization as vx


class _FakeLib:
    """Stands in for ``kernels.lib(name)``: checks the launcher's name and
    each argument against ``kernels.SIGNATURES``, returns success."""

    calls = []

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
            return 0

        return launch


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(kernels, "lib", _FakeLib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for mod in (fa, fs, vx):
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fa, "sm_count", lambda t: 132)
    _FakeLib.calls = []
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
    with pytest.raises(ValueError):  # C = 96: neither < 64 nor % 64
        fs.fused_lstm_scan(torch.randn(3, 2, 4, 5, 96), _bf(192, 384),
                           _bf(384), torch.zeros(2, 4, 5, 96),
                           torch.zeros(2, 4, 5, 96))
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


def test_train_wrappers_launch_once_and_count(fake_cuda):
    """The training kernels' wrappers: one launch each (plus the in-order
    sum of their partials, ``rvt_sum_parts``), counted where they launch."""
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
        + ["rvt_partition_attention_bwd"] + ["rvt_ls_bwd", "rvt_sum_parts"]
        + ["rvt_colsum", "rvt_sum_parts"] + ["rvt_lstm_scan"]
        + ["rvt_lstm_scan_bwd", "rvt_gemm_bf16_wgrad", "rvt_sum_parts",
           "rvt_sum_parts"])
    assert [c.launches - b for c, b in zip(counters, before)] == [
        4, 1, 2, 1, 9, 1, 1]


def test_train_wrappers_reject_what_the_kernels_do_not_take(fake_cuda):
    with pytest.raises(ValueError):  # C = 96 is not a power of two
        fa.ln_rows_bwd(torch.randn(40, 96), torch.randn(40, 96), _bf(96),
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
