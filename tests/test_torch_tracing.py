"""The port's tracing (``rvt_tpu_torch/utils/timers.py``) on the CPU, at
gen1 tiny (64 x 80, T = 3, K = 2): the eval, train and raw steps run
eagerly with tracing on give their documented layers in order, one call
id a step call, tiling the step; a span's self time is its duration less
its children's; ``nms_candidates`` counts the boxes above the confidence
threshold, ``simota_pairs`` the pairs SimOTA costs and ``launches`` the
kernels' counters' deltas; a data-parallel train step marks
``allreduce``; the neck's and head's backward ends before any backbone
node runs, which is where the train step's ``backbone_bwd`` layer
starts; with tracing off nothing is recorded and no event is made. ``test_torch_cuda.py`` checks the layers
of captured replays on a card."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from rvt_tpu_torch.config import preset
from rvt_tpu_torch.inference import make_raw_inference_step
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import init_detector, scan_backbone
from rvt_tpu_torch.ops.kernels import COUNTERS, Counter
from rvt_tpu_torch.training import graphs
from rvt_tpu_torch.training.losses import yolox_loss
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import (gather_labeled_frames,
                                         gather_labels, head_grid,
                                         make_eval_step, make_train_step,
                                         pad_ev_repr)
from rvt_tpu_torch.utils import timers

B, T, CONF = 2, 3, 1e-4
LAYERS = {"eval": ["input", "backbone", "detect", "postprocess"],
          "train": ["input", "backbone", "detect", "loss", "detect_bwd",
                    "backbone_bwd", "optimizer"],
          "raw": ["input", "backbone", "detect", "postprocess"]}


@pytest.fixture(autouse=True)
def _one_thread_and_clean_timers():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    timers.reset()
    yield
    timers.enable(False)
    timers.reset()
    torch.set_num_threads(n)


def _cfg():
    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=T,
                 max_labels_per_frame=4, max_labeled_frames=2)
    return replace(cfg, model=replace(
        cfg.model, compute_dtype="bfloat16",
        backbone=replace(cfg.model.backbone, fused_kernels=True),
        postprocess=replace(cfg.model.postprocess,
                            confidence_threshold=CONF)))


def _steps():
    """(kind, step, its arguments, the model) for the three steps."""
    cfg = _cfg()
    model = init_detector(cfg.model, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    ev = torch.from_numpy(rng.randint(0, 4, (B, T, 64, 80, 20)).astype(
        np.uint8))
    fv = torch.tensor([[False, True, True]] * B)
    first = torch.tensor([True, False])
    states = zero_states(cfg.model.backbone, B, device="cpu")
    labels = torch.zeros(B, T, 4, 7)
    labels[..., 1:3] = 20.0
    labels[..., 3:5] = 16.0
    mask = torch.ones(B, T, 4, dtype=torch.bool)
    N = 500
    g = torch.Generator().manual_seed(0)
    xy = [torch.randint(0, hi, (B, N), generator=g, dtype=torch.int32)
          for hi in (80, 64, 2)]
    t = torch.sort(torch.randint(0, 50_000, (B, N), generator=g,
                                 dtype=torch.int32), dim=1).values
    counts = torch.tensor([N, N // 2], dtype=torch.int32)
    opt = make_optimizer(model.parameters(), cfg.training)
    return cfg, model, [
        ("eval", make_eval_step(model, cfg), (states, ev, fv, first)),
        ("train", make_train_step(model, cfg, opt),
         (states, ev, labels, mask, fv, first)),
        ("raw", make_raw_inference_step(model, cfg),
         (states, *xy, t, counts, first))]


def _host(r):
    return r.t1 - r.t0


@pytest.fixture(scope="module")
def traced():
    """Each step called twice with tracing on: (records, summary,
    launches the counters made, outputs, head outputs)."""
    torch.set_num_threads(1)
    timers.reset()
    cfg, model, steps = _steps()
    preds = []
    model.register_forward_hook(lambda m, i, out: preds.append(out[0]))
    outs = {}
    timers.enable(True)
    try:
        n = sum(c.launches for c in COUNTERS)
        for kind, step, args in steps:
            outs[kind] = [step(*args) for _ in range(2)]
        made = sum(c.launches for c in COUNTERS) - n
    finally:
        timers.enable(False)
    recs, s = timers.records(), timers.summary()
    timers.reset()
    return recs, s, made, outs, preds


@pytest.mark.parametrize("kind", ["eval", "train", "raw"])
def test_layers_in_order_one_call_id_tiling_the_step(traced, kind):
    recs, _, _, _, _ = traced
    i = ["eval", "train", "raw"].index(kind)
    steps = [r for r in recs if r.name == "step"][2 * i:2 * i + 2]
    assert len({r.call for r in steps}) == 2
    for step in steps:
        mine = [r for r in recs if r.call == step.call]
        eager = [r for r in mine if r.name == "step.eager"]
        assert len(eager) == 1 and eager[0].pid == step.rid
        eager = eager[0]
        layers = [r for r in mine if r.pid == eager.rid]
        assert [r.name for r in layers] == LAYERS[kind]
        assert all(r.parent == "step.eager" for r in layers)
        # tiling: each layer starts where the last ended, inside the step
        for a, b in zip(layers, layers[1:]):
            assert a.t1 == b.t0 and _host(a) >= 0
        assert eager.t0 <= layers[0].t0 and layers[-1].t1 <= eager.t1
        assert layers[-1].t1 - layers[0].t0 >= 0.95 * _host(eager)
        assert step.t0 <= eager.t0 and eager.t1 <= step.t1


def test_self_time_is_duration_less_children(traced):
    recs, s, _, _, _ = traced
    spans = [r for r in recs if r.value is None]
    for name in ("step", "step.eager", "step.before", "backbone"):
        mine = [r for r in spans if r.name == name]
        host = sum(_host(r) for r in mine)
        kids = sum(_host(c) for r in mine for c in spans if c.pid == r.rid)
        assert s["spans"][name]["count"] == len(mine)
        assert s["spans"][name]["host_s"] == pytest.approx(host * 1e-9)
        assert s["spans"][name]["self_s"] == pytest.approx(
            (host - kids) * 1e-9)
    assert s["spans"]["step"]["count"] == 6
    assert s["spans"]["step.before"]["count"] == 2  # the train step's


def test_launches_are_the_counters_deltas(traced):
    recs, s, made, _, _ = traced
    launches = [r for r in recs if r.name == "launches"]
    assert len(launches) == 6 and all(r.parent == "step" for r in launches)
    assert s["counters"]["launches"]["sum"] == made

    c = Counter("test_tracing")
    step = graphs.CapturedStep(lambda x: setattr(c, "launches",
                                                 c.launches + 3) or x + 1)
    timers.enable(True)
    step(torch.ones(2))
    timers.enable(False)
    COUNTERS.remove(c)
    (r,) = [r for r in timers.records() if r.name == "launches"]
    assert (r.value, r.items) == (3, 1)


def _above(preds):
    """Boxes of each frame whose score passes the confidence threshold."""
    p = preds.float()
    score = torch.sigmoid(p[..., 4]) * torch.sigmoid(p[..., 5:]).amax(-1)
    return (score >= CONF).sum(-1)


def test_nms_candidates_count_boxes_above_threshold(traced):
    recs, _, _, outs, preds = traced
    n = [r for r in recs if r.name == "nms_candidates"]
    assert [r.parent for r in n] == ["step"] * 4  # 2 eval, 2 raw calls
    for r, out in zip(n[:2], outs["eval"]):
        assert (r.value, r.items) == (int(_above(out.preds).sum()), B * 2)
    # the raw calls' head outputs, as the detector's forward hook saw them
    for r, p in zip(n[2:], preds[-2:]):
        assert (r.value, r.items) == (int(_above(p).sum()), B)
    assert 0 < n[0].value < n[0].items * out.preds.shape[1]


def test_simota_pairs_count_the_costed_pairs(traced):
    """Each train step counts the (gt, anchor) pairs SimOTA costs: every
    valid box of the gathered labelled frames with every anchor whose
    centre lies inside the 1.5-stride radius of a box's centre."""
    recs, _, _, _, _ = traced
    n = [r for r in recs if r.name == "simota_pairs"]
    assert [r.parent for r in n] == ["step"] * 2  # the 2 train calls
    grid, stride = head_grid(_cfg())
    centre = (grid + 0.5) * stride[:, None]
    # the test's boxes: 4 a frame, all at (28, 28), on 2 labelled frames
    # of each lane
    inside = (np.abs(centre - 28.0) < 1.5 * stride[:, None]).all(-1).sum()
    assert inside > 0
    assert [(r.value, r.items) for r in n] == [(B * 2 * 4 * inside, 1)] * 2


def test_allreduce_layer_only_with_a_group(tmp_path):
    """With a data-parallel group the train step marks ``allreduce``
    between the backward and the optimizer (a world of one rank over
    gloo, eagerly); without one its layers are ``LAYERS["train"]``
    (``test_layers_in_order_one_call_id_tiling_the_step``)."""
    import torch.distributed as dist

    cfg, model, steps = _steps()
    (_, _, args), = [s for s in steps if s[0] == "train"]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        opt = make_optimizer(model.parameters(), cfg.training)
        step = make_train_step(model, cfg, opt, group=dist.group.WORLD)
        timers.enable(True)
        step(*args)
        timers.enable(False)
    finally:
        dist.destroy_process_group()
    recs = timers.records()
    (eager,) = [r for r in recs if r.name == "step.eager"]
    names = [r.name for r in recs if r.pid == eager.rid]
    want = LAYERS["train"][:-1] + ["allreduce", "optimizer"]
    assert names == want


def test_off_records_nothing_and_makes_no_event(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an event made with tracing off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, _, steps = _steps()
    for _, step, args in steps:
        step(*args)
    with timers.span("x", "cpu"):
        timers.mark("y")
        timers.count("z", 1)
    timers.add_count("z", 1)
    assert timers.records() == []
    assert timers.summary() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_neck_backward_ends_before_the_backbone_backward(device):
    """Autograd runs every node of the loss, head and neck before any node
    of the backbone, so that the gradients of the gathered features mark
    the boundary: the last of their hooks fires after every node that
    only the neck's side reaches and before every node the backbone's
    features reach. On a card (``-m cuda``), the kernels' backward."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = _cfg()
    model = init_detector(cfg.model, seed=0, device=device).train()
    rng = np.random.RandomState(0)
    ev = torch.from_numpy(rng.randint(0, 4, (B, T, 64, 80, 20)).astype(
        np.uint8)).to(device)
    x = pad_ev_repr(ev, cfg.model.backbone.in_res_hw, torch.float32)
    feats, _ = scan_backbone(model, x.transpose(0, 1),
                             zero_states(cfg.model.backbone, B,
                                         device=device),
                             deterministic=False, remat=True)
    fv = torch.tensor([[False, True, True]] * B, device=device)
    gathered, idx, gval = gather_labeled_frames(feats, fv, 2)
    preds = model.forward_detect(gathered)
    labels = torch.zeros(B, T, 4, 7, device=device)
    labels[..., 1:3] = 20.0
    labels[..., 3:5] = 16.0
    targets, tmask = gather_labels(
        labels, torch.ones(B, T, 4, dtype=torch.bool, device=device), idx)
    grid, stride = (torch.from_numpy(a).to(device) for a in head_grid(cfg))
    loss = yolox_loss(preds, targets, tmask, gval.reshape(-1), grid, stride,
                      cfg.model.head.num_classes)["loss"]

    def reach(roots):
        seen, todo = set(), [r for r in roots if r is not None]
        while todo:
            node = todo.pop()
            if node in seen:
                continue
            seen.add(node)
            todo += [f for f, _ in node.next_functions if f is not None]
        return seen
    backbone = reach([f.grad_fn for f in feats])
    neck = reach([loss.grad_fn]) - reach([g.grad_fn for g in gathered])
    assert backbone and neck
    order = []
    for node in backbone | neck:
        node.register_prehook(lambda g, node=node: order.append(node))

    class Nodes(timers.Layers):
        """Marks by the number of nodes run so far."""

        def mark(self, name, end=False):
            self.marks.append((name, len(order)))
    with Nodes() as c:
        timers.mark_after_grads(gathered, "backbone_bwd")
        loss.backward()
    (name, at), end = c.marks
    assert name == "backbone_bwd" and end == ("", len(order))
    ran = {node: i for i, node in enumerate(order)}
    assert [n for n in neck if n in ran] and [n for n in backbone
                                              if n in ran]
    assert all(ran[n] < at for n in neck if n in ran)
    assert all(ran[n] >= at for n in backbone if n in ran)
