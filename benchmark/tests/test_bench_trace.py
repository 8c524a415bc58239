"""The trace reader on a hand-made trace: device busy time is the union
of the device's intervals, the hand-written kernels are told by name,
and each idle gap is named by the innermost host event over it."""
import pytest

from benchmark.core.trace import is_hand_kernel, read_trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_union_hand_kernels_and_gaps():
    events = [
        ev("user_annotation", "bench.subwindow", 0, 100),
        ev("kernel", "void (anonymous namespace)::gemm_kernel<2>(int)", 10,
           20),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
           20, 20),  # overlaps the first: counted once in busy
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 70, 10),
        ev("cuda_runtime", "cudaStreamSynchronize", 40, 30),
        ev("cpu_op", "aten::copy_", 38, 40),
    ]
    p = read_trace(events, calls=2, wall=1e-4)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx(40e-6)  # [10, 40) and [70, 80)
    assert p.hand_s == pytest.approx(20e-6)
    assert p.other_kernel_s == pytest.approx(20e-6)
    assert p.hand_names == {"gemm_kernel": pytest.approx(20e-6)}
    # longest first: [40, 70) under the sync, [80, 100), [0, 10)
    assert [n for n, _ in p.idle_gaps] == ["cudaStreamSynchronize",
                                          "host idle", "host idle"]
    assert [s for _, s in p.idle_gaps] == pytest.approx([30e-6, 20e-6,
                                                          10e-6])


@pytest.mark.parametrize("name, hand", [
    ("void (anonymous namespace)::lstm_scan_kernel<64, 2>(Params)", True),
    ("(anonymous namespace)::nms_keep_kernel(float const*)", True),
    ("void at::native::(anonymous namespace)::scan_kernel()", False),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", False),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel()", False)])
def test_hand_kernel_names(name, hand):
    assert is_hand_kernel(name) is hand
