"""The port's captured steps (rvt_tpu_torch.training.graphs) without a card:
the signature a graph is keyed by, the eager path a CPU call takes, the
kernels' workspaces that a graph may address, and the card route of the
eval, raw and train step bodies, which must read nothing back from the
device (a host read inside a CUDA graph capture raises). The last runs
every wrapper's CUDA side on the fake-CUDA stand-in of
``test_torch_wrappers.py`` under a torch function mode that refuses host
reads. ``test_torch_cuda.py`` captures and replays the steps on a card."""
import contextlib
import gc
import weakref
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

from rvt_tpu_torch.config import preset
from rvt_tpu_torch.inference import make_raw_inference_step
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import (fused_train_scan_backbone,
                                           init_detector)
from rvt_tpu_torch.ops import bn_act, boxes
from rvt_tpu_torch.ops import fused_attention as fa
from rvt_tpu_torch.ops import fused_scan as fs
from rvt_tpu_torch.ops import kernels
from rvt_tpu_torch.ops import voxelization as vx
from rvt_tpu_torch.ops.s2d import s2d_input_hw
from rvt_tpu_torch.training import graphs
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import make_eval_step, make_train_step

from tests.test_torch_wrappers import _FakeLib


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# reads of device values into the host, and tensors made from host data
# (on a card an unpinned copy, refused inside a capture)
_HOST_READS = {"__bool__", "__int__", "__float__", "__index__", "item",
               "tolist", "numpy", "cpu", "nonzero", "argwhere",
               "masked_select", "unique", "unique_consecutive",
               "from_numpy", "tensor", "as_tensor"}


class _NoHostReads(TorchFunctionMode):
    """Raises on every torch call that reads a tensor's values into the
    host (on a card: a device synchronisation, refused inside a capture)
    or makes a tensor from host data, and on indexing by a bool tensor (a
    hidden ``nonzero``)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _HOST_READS:
            raise AssertionError(f"host read: {name}")
        if name == "__getitem__" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in pytree.tree_leaves(args[1:])):
            raise AssertionError("host read: indexing by a bool tensor")
        return func(*args, **(kwargs or {}))


def _from_numpy(*args, **kwargs):
    raise AssertionError("host data: from_numpy")


@contextlib.contextmanager
def forbid_host_reads():
    """Within: ``_NoHostReads``, and ``torch.from_numpy`` (which no torch
    function mode sees) raises."""
    from_numpy = torch.from_numpy
    torch.from_numpy = _from_numpy
    try:
        with _NoHostReads():
            yield
    finally:
        torch.from_numpy = from_numpy


def test_forbid_host_reads_catches_them():
    x = torch.arange(4.0)
    with forbid_host_reads():
        y = torch.where(x > 1, x, 0) * 2  # device-side work passes
        for read in (lambda: bool(x.sum() > 0), lambda: float(x.sum()),
                     lambda: x.tolist(), lambda: x[x > 1],
                     lambda: x.nonzero(), lambda: int(x.argmax()),
                     lambda: torch.tensor([1.0]),
                     lambda: torch.from_numpy(np.zeros(2))):
            with pytest.raises(AssertionError, match="host"):
                read()
    assert y.tolist() == [0.0, 0.0, 4.0, 6.0]


def test_signature_keys_shapes_dtypes_and_given_arguments():
    """A graph per signature: the shapes, dtypes and devices of the
    tensors, the other leaves' values, and which optional arguments are
    given (the analogue of a retrace); tensor values do not count."""
    def sig(*args, **kwargs):
        return graphs.signature(*pytree.tree_flatten((args, kwargs)))

    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    states = ((a, b), (a, b))
    base = sig(states, a, token_mask=None)
    assert sig(((b, a), (b, a)), b, token_mask=None) == base
    assert sig(states, a, token_mask=a) != base
    assert sig(states, a) != base
    assert sig(states, torch.zeros(2, 4), token_mask=None) != base
    assert sig(states, a.double(), token_mask=None) != base
    assert sig(states, a, 3) != sig(states, a, 4)


def test_captured_step_runs_eagerly_on_the_cpu():
    """On CPU tensors a CapturedStep is its body: ``before`` then ``fn`` at
    every call, fresh results, no graph; ``eager()`` nests and restores."""
    calls = []

    def fn(x, scale=None):
        calls.append("fn")
        return {"y": x * (1 if scale is None else scale), "n": len(calls)}

    step = graphs.CapturedStep(fn, before=lambda: calls.append("before"))
    x = torch.arange(3.0)
    out1 = step(x)
    out2 = step(x, scale=torch.tensor(2.0))
    assert calls == ["before", "fn"] * 2 and step.graphs == {}
    assert torch.equal(out1["y"], x) and torch.equal(out2["y"], 2 * x)
    assert out1["y"] is not out2["y"]
    with graphs.eager():
        with graphs.eager():
            assert graphs._EAGER[0]
        assert graphs._EAGER[0]
        step(x)
    assert not graphs._EAGER[0] and calls[-2:] == ["before", "fn"]
    assert step.run_eager(x)["n"] == len(calls)


def test_replaced_workspaces_are_never_freed():
    """A graph captured with a workspace writes it at every replay; a
    larger call replaces the workspace, and the old one must stay
    allocated (``kernels.retire``) or the allocator would hand its memory
    to another tensor under the graph."""
    like = torch.zeros(1)
    vx._HIST_WS.pop(like.get_device(), None)
    fa._WORKSPACE.pop(like.get_device(), None)
    table, chunk = vx._hist_workspace(like, 10, 100)
    part = fa._reduce_workspace(like, 100)[1]
    refs = [weakref.ref(t) for t in (table, chunk, part)]
    t2, c2 = vx._hist_workspace(like, 4 * table.numel(), 4 * chunk.numel())
    p2 = fa._reduce_workspace(like, 4 * part.numel())[1]
    assert t2.numel() > table.numel() and c2.numel() > chunk.numel()
    assert p2.numel() > part.numel()
    # a call that fits keeps the workspace
    assert vx._hist_workspace(like, 10, 100)[0] is t2
    del table, chunk, part
    gc.collect()
    assert all(r() is not None for r in refs)
    assert any(t is r() for t in kernels._RETIRED for r in refs)
    vx._HIST_WS.pop(like.get_device(), None)
    fa._WORKSPACE.pop(like.get_device(), None)


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(kernels, "lib", _FakeLib)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for mod in (fa, fs, vx, boxes, bn_act):
        monkeypatch.setattr(mod, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(fa, "sm_count", lambda t: 132)
    _FakeLib.calls = []
    _FakeLib.launches = []
    return _FakeLib.calls


def _kernel_cfg(stem_s2d, masked=False):
    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=3,
                 max_labels_per_frame=4, max_labeled_frames=2)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         stem_s2d=stem_s2d, enable_masking=masked),
        postprocess=replace(cfg.model.postprocess, pre_nms_topk=0)))


@pytest.mark.parametrize("masked", [False, True])
def test_card_route_of_the_steps_reads_nothing_back(fake_cuda, masked):
    """The bodies a card captures (eval, raw, train with both variants and
    a token mask, the per-step train backbone's forward and backward), on
    every wrapper's CUDA side: after one eager call (the
    warm-up, which may fill caches from the host), no host read, every
    kernel of each path launched, NMS on ``nms_keep`` over all anchors."""
    B, T = 2, 3
    cfg = _kernel_cfg(stem_s2d=True, masked=masked)
    model = init_detector(cfg.model, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    hp, wp = s2d_input_hw(cfg.model.backbone.in_res_hw)
    ev = torch.from_numpy(rng.randint(0, 4, (B, T, hp, wp, 320)).astype(
        np.uint8))
    fv = torch.tensor([[False, True, True]] * B)
    first = torch.tensor([True, False])
    states = zero_states(cfg.model.backbone, B, device="cpu")
    eval_step = make_eval_step(model, cfg)
    assert isinstance(eval_step, graphs.CapturedStep)
    eval_step.fn(states, ev, fv, first)
    n_nms = boxes.NMS_KEEP.launches
    _FakeLib.launches.clear()
    with forbid_host_reads():
        out = eval_step.fn(states, ev, fv, first)
    assert out.dets.shape == (B, 2, cfg.model.postprocess.max_detections, 7)
    assert boxes.NMS_KEEP.launches == n_nms + 1
    A = out.preds.shape[1]
    (nms_args,) = [a for f, a in _FakeLib.launches if f == "rvt_nms_keep"]
    assert nms_args[4:6] == (B * 2, A)  # every anchor, no 512 branch

    opt = make_optimizer(model.parameters(), cfg.training)
    train = make_train_step(model, cfg, opt, with_detections=True,
                            with_param_metrics=True)
    labels = torch.zeros(B, T, 4, 7)
    labels[..., 3:5] = 8.0
    tm = torch.zeros(B, T, 16, 20, dtype=torch.bool) if masked else None
    args = (states, ev, labels, torch.ones(B, T, 4, dtype=torch.bool), fv,
            first, tm)
    train.fn(*args)
    grads = [p.grad for p in model.parameters()]
    _FakeLib.calls.clear()
    with forbid_host_reads():
        st, metrics, dets = train.fn(*args)
    assert "grad_norm" in metrics and len(dets) == 4
    assert all(p.grad is g for p, g in zip(model.parameters(), grads))
    for fn in ("rvt_gemm_bf16", "rvt_gemm_bf16_wgrad", "rvt_lstm_scan",
               "rvt_lstm_bwd_scan", "rvt_partition_attention_bwd",
               "rvt_ln_rows_bwd", "rvt_nms_keep", "rvt_bn_moments",
               "rvt_bn_act_fwd", "rvt_bn_act_bwd_sums", "rvt_bn_act_bwd_dy"):
        assert fn in _FakeLib.calls, fn

    # the per-step train backbone (row 7), forward and backward
    bcfg = _kernel_cfg(stem_s2d=False)
    bmodel = init_detector(bcfg.model, seed=0, device="cpu")
    H, W = bcfg.model.backbone.in_res_hw
    seq = torch.zeros(T, B, H, W, 20)

    def per_step():
        bmodel.zero_grad(set_to_none=True)
        feats, final = fused_train_scan_backbone(
            bmodel, seq, zero_states(bcfg.model.backbone, B, device="cpu"),
            per_step=True)
        sum(f.float().sum() for f in feats).backward()

    per_step()
    _FakeLib.calls.clear()
    with forbid_host_reads():
        per_step()
    assert "rvt_lstm_bwd_scan" in _FakeLib.calls

    raw_cfg = _kernel_cfg(stem_s2d=False)
    raw_model = init_detector(raw_cfg.model, seed=0, device="cpu")
    raw = make_raw_inference_step(raw_model, raw_cfg)
    N = 64
    x, y, p, t = (torch.zeros(B, N, dtype=torch.int32) for _ in range(4))
    counts = torch.full((B,), N, dtype=torch.int32)
    args = (zero_states(raw_cfg.model.backbone, B, device="cpu"), x, y, p,
            t, counts, first)
    raw.fn(*args)
    _FakeLib.calls.clear()
    with forbid_host_reads():
        raw.fn(*args)
    assert "rvt_stacked_histogram" in _FakeLib.calls
    assert "rvt_nms_keep" in _FakeLib.calls
