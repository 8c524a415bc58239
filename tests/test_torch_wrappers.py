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
        expected, argtypes = kernels.SIGNATURES[self.name]
        assert fn == expected

        def launch(*args):
            assert len(args) == len(argtypes), (fn, len(args))
            for a, t in zip(args, argtypes):
                if t is ctypes.c_void_p:
                    assert a is None or isinstance(a, (ctypes.c_void_p, int))
                elif t is ctypes.c_int:
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
        assert fa.gemm_bf16(_bf(40, 64), _bf(64, 96), _bf(96), epi).shape \
            == (40, 96)
    R = torch.zeros(40, 96)
    assert fa.gemm_bf16(_bf(40, 64), _bf(64, 96), _bf(96), "residual",
                        R) is R
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
        fa.gemm_bf16(_bf(40, 12), _bf(12, 96), _bf(96), "bias")
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
