"""The eval window's layout in one pass (``rvt_tpu_torch/ops/s2d.py:
window_s2d``) on the CPU: its plain version against the JAX package's
``device_space_to_depth`` frame by frame, and the steps' route by the
window's last axis (``training/step.py:window_seq``): an unblocked window
and the same window blocked on the host give the same eval outputs and the
same train loss, bit for bit. ``test_torch_cuda.py`` holds the kernel
against the plain version on a card; ``test_torch_wrappers.py`` its
launch."""
import copy
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.ops import s2d as j_s2d
from rvt_tpu_torch.config import preset
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import init_detector
from rvt_tpu_torch.ops import s2d as t_s2d
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import (make_eval_step, make_train_step,
                                         window_seq)

B, T = 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stored(rng, b, t, c, hw, high=256):
    """A stored window [B, T, C, H, W] and its channel-last view."""
    st = torch.from_numpy(rng.randint(0, high, (b, t, c) + hw
                                      ).astype(np.uint8))
    return st, st.permute(0, 1, 3, 4, 2)


# (storage hw, model hw, channels): gen1, a gen4-like frame, a tiny odd one
@pytest.mark.parametrize("layout", ["stored", "contiguous"])
@pytest.mark.parametrize("hw,target,c", [((240, 304), (256, 320), 20),
                                         ((360, 640), (384, 640), 20),
                                         ((13, 21), (16, 24), 3)],
                         ids=["gen1", "gen4", "tiny_odd"])
def test_window_s2d_plain_equals_jax_frame_by_frame(hw, target, c, layout):
    """``window_s2d`` on the CPU (its plain version) against JAX's
    ``device_space_to_depth`` of each frame, T-major, in bf16: exact, from
    the stored buffer's channel-last view and from a contiguous
    channel-last window."""
    b, t = (1, 2) if hw[0] > 300 else (2, 3)
    _, ev = _stored(np.random.RandomState(5), b, t, c, hw)
    if layout == "contiguous":
        ev = ev.contiguous()
    got = t_s2d.window_s2d(ev, target)
    frames = ev.numpy()
    want = np.stack([np.stack([np.asarray(j_s2d.device_space_to_depth(
        jnp.asarray(frames[i, j]), target)) for i in range(b)])
        for j in range(t)])
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_window_s2d_rejects_on_the_cpu_what_the_card_rejects():
    """The CPU route takes the windows the kernel takes and no others: a
    float window, one larger than the model's frame and a frame not of
    whole blocks raise, as on a card, and nothing is rounded to bf16."""
    _, ev = _stored(np.random.RandomState(6), 1, 2, 20, (240, 304))
    for bad, target in ((ev.float(), (256, 320)), (ev, (236, 320)),
                        (ev, (256, 318))):
        for plain in (False, True):
            with pytest.raises(ValueError):
                t_s2d.window_s2d(bad, target, plain=plain)


def _cfg(kernels: bool):
    """gen1 tiny (64 x 80 events, model 64 x 96) with the s2d stem: on the
    kernels' plain versions in bf16, or the module path as shipped."""
    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=T,
                 max_labels_per_frame=4, max_labeled_frames=2)
    model = replace(cfg.model, backbone=replace(cfg.model.backbone,
                                                stem_s2d=True))
    if kernels:
        model = replace(model, compute_dtype="bfloat16",
                        backbone=replace(model.backbone,
                                         fused_kernels=True))
    model = replace(model, postprocess=replace(model.postprocess,
                                               confidence_threshold=1e-4))
    return replace(cfg, model=model)


def _windows(cfg, high=6):
    """The stored window's channel-last view and its host s2d blocking."""
    _, ev = _stored(np.random.RandomState(6), B, T, 20, (64, 80), high)
    blocked = torch.from_numpy(t_s2d.host_space_to_depth(
        ev.numpy(), cfg.model.backbone.in_res_hw))
    return ev, blocked


def _equal_trees(a, b):
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y


def test_window_seq_routes_by_the_last_axis():
    """An unblocked window becomes the stem's bf16 operand, T-major; a
    blocked one keeps its storage dtype; a blocked one of another size
    raises, as ``pad_ev_repr`` does."""
    cfg = _cfg(kernels=True)
    bb = cfg.model.backbone
    ev, blocked = _windows(cfg)
    x = window_seq(ev, bb, None)
    y = window_seq(blocked, bb, None)
    assert x.dtype == torch.bfloat16 and y.dtype == torch.uint8
    assert x.shape == y.shape == (T, B, 17, 25, 320) and x.is_contiguous()
    assert torch.equal(x, y.to(torch.bfloat16))
    assert torch.equal(window_seq(ev, bb, torch.float32), y.float())
    with pytest.raises(ValueError):
        window_seq(blocked[:, :, 1:], bb, None)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels",
                                                         "modules"])
def test_eval_step_takes_unblocked_and_blocked_windows_alike(kernels):
    """The eval step over three carried windows, fed the stored window's
    channel-last view and the same window blocked on the host: equal
    ``EvalOutput``s, bit for bit (the stem's operand is the same)."""
    cfg = _cfg(kernels)
    ev, blocked = _windows(cfg)
    fv = torch.tensor([[False, True, True]] * B)
    first = torch.tensor([True, False])
    model = init_detector(cfg.model, seed=0, device="cpu")
    step = make_eval_step(model, cfg)

    def run(x):
        states, outs = zero_states(cfg.model.backbone, B, device="cpu"), []
        for _ in range(3):
            out = step(states, x, fv, first)
            states = out.states
            outs.append(out)
        return outs

    _equal_trees(run(ev), run(blocked))


def test_train_step_takes_unblocked_and_blocked_windows_alike():
    """Two train steps from the same weights, one fed the unblocked
    window and one the host-blocked one: the same loss and states, and
    the same updated parameters, bit for bit."""
    cfg = _cfg(kernels=True)
    ev, blocked = _windows(cfg)
    labels = torch.zeros(B, T, 4, 7)
    labels[..., 1:3] = 20.0
    labels[..., 3:5] = 16.0
    mask = torch.ones(B, T, 4, dtype=torch.bool)
    fv = torch.tensor([[False, True, True]] * B)
    first = torch.tensor([True, False])
    model = init_detector(cfg.model, seed=0, device="cpu")
    models = [model, copy.deepcopy(model)]
    outs = []
    for m, x in zip(models, (ev, blocked)):
        step = make_train_step(m, cfg, make_optimizer(m.parameters(),
                                                      cfg.training))
        states = zero_states(cfg.model.backbone, B, device="cpu")
        outs.append(step(states, x, labels, mask, fv, first))
    (s0, m0), (s1, m1) = outs
    assert torch.isfinite(m0["loss"])
    assert torch.equal(m0["loss"], m1["loss"])
    _equal_trees(s0, s1)
    for pa, pb in zip(*(m.parameters() for m in models)):
        assert torch.equal(pa, pb)
