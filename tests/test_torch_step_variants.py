"""The train step's variants (``make_train_step(with_detections=True,
with_param_metrics=True)``), the kernels' plain versions on the CPU,
against the JAX package's over test_torch_train_step.py's two carried
gen1-tiny windows (geometric assignment on both sides). The confidence
threshold is 2e-4: with random weights every score lies near 1e-4 (the
head's prior), so at the shipped 0.1 NMS would see nothing; at 2e-4 it
sees 10-40 candidates per labelled frame and suppresses some."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.ops.boxes import postprocess as j_postprocess
from rvt_tpu_torch.convert.from_flax import from_flax
from tests import test_torch_train_step as ts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CONF = 2e-4
MATCH_IOU, MATCHED = 0.5, 0.9


@pytest.fixture(scope="module")
def runs():
    return ts.train_runs(conf=CONF)


def test_variant_step_matches_plain_step(runs):
    """The variants change nothing the plain step computes."""
    ts.check_losses(runs)
    ts.check_final_states(runs)
    ts.check_grads(runs)


def _port_names(runs):
    """{flax path 'a/b/c': port parameter name}, through from_flax's key
    map (each leaf filled with its index, so the transposes keep it)."""
    params = runs["state"].params
    flat = {}

    def fill(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = fill(v, path)
            else:
                flat[len(flat)] = path
                out[k] = np.full(np.shape(v), len(flat) - 1, np.float32)
        return out

    sd = from_flax({"params": fill(params, "")})
    return {flat[int(t.flatten()[0])]: n for n, t in sd.items()}


def test_param_metrics_names_and_values(runs):
    """One gradflow/ and one weights/ entry per parameter, under the
    port's names (JAX's through the key map); gradflow is the mean |grad|
    the step left in .grad, weights the mean |w| after the update."""
    names = _port_names(runs)
    tmodel = runs["tmodel"]
    own = [n for n, _ in tmodel.named_parameters()]
    assert sorted(names.values()) == sorted(own)
    _, tm = runs["tout"][-1]
    _, jm = runs["jout"][-1]
    for kind in ("gradflow", "weights"):
        assert {k for k in tm if k.startswith(kind + "/")} == {
            f"{kind}/{n}" for n in own}
        assert {f"{kind}/{names[k[len(kind) + 1:]]}" for k in jm
                if k.startswith(kind + "/")} == {f"{kind}/{n}" for n in own}
    for n, p in tmodel.named_parameters():
        g = p.grad.abs().mean() if p.grad is not None else torch.zeros(())
        assert tm[f"gradflow/{n}"] == float(g), n
        assert tm[f"weights/{n}"] == float(p.detach().abs().mean()), n


def test_param_metrics_match_jax(runs):
    """weights/: each within the two updates' bound on the parameters
    (2 (lr0 + lr1), test_torch_train_step.py). gradflow/ of the first
    window: the vector of means within twice its move under the 1e-3 stem
    weight move, as the gradients are held."""
    names = _port_names(runs)
    lr0, lr1 = runs["lrs"]
    _, tm = runs["tout"][-1]
    _, jm = runs["jout"][-1]
    for path, n in names.items():
        assert abs(tm[f"weights/{n}"] - float(jm[f"weights/{path}"])) <= \
            2 * (lr0 + lr1) * 1.001, n
    _, tm0 = runs["tout"][0]
    _, jm0 = runs["jout"][0]
    moved = runs["grads"][2]
    order = sorted(names)
    port = torch.tensor([tm0[f"gradflow/{names[p]}"] for p in order],
                        dtype=torch.float64)
    ref = torch.tensor([float(jm0[f"gradflow/{p}"]) for p in order],
                       dtype=torch.float64)
    mov = torch.tensor([float(moved[names[p]].abs().mean()) for p in order],
                       dtype=torch.float64)
    assert ts._l2(port, ref) <= 2 * ts._l2(mov, port)


def test_detections_are_the_postprocess_of_the_forward(runs):
    """The variant's (dets, det_valid) equal JAX's postprocess of the same
    step's decoded predictions; NMS saw candidates and suppressed some."""
    cfg = runs["cfg"]
    pp, nc = cfg.model.postprocess, cfg.model.head.num_classes
    for _, (dets, valid, frame_idx, gval), preds in runs["dets"]:
        p = preds.numpy()
        infer = np.concatenate([p[..., :4], 1 / (1 + np.exp(-p[..., 4:]))],
                               -1)
        dj, vj = j_postprocess(jnp.asarray(infer), nc, pp.confidence_threshold,
                               pp.nms_threshold, pp.pre_nms_topk,
                               pp.max_detections)
        Bk, K = frame_idx.shape
        vj = np.asarray(vj).reshape(Bk, K, -1) & gval.numpy()[..., None]
        np.testing.assert_array_equal(valid.numpy(), vj)
        dj = np.asarray(dj).reshape(dets.shape)
        np.testing.assert_allclose(dets.numpy()[vj], dj[vj], rtol=1e-5,
                                   atol=1e-5)
        scores = infer[..., 4:5] * infer[..., 5:5 + nc]
        cand = (scores > pp.confidence_threshold).any(-1).reshape(Bk, K, -1)
        cand &= gval.numpy()[..., None]
        assert valid.sum() > 0 and valid.sum() < cand.sum()


def _iou(a, b):
    """IoU of xyxy boxes a [n, 4] and b [m, 4]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), -1)
    area = lambda x: np.prod(x[:, 2:] - x[:, :2], -1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def test_detections_match_jax(runs):
    """Against JAX's variant step: the same frames; per labelled frame the
    number of detections within 2, and 90 % of JAX's detections met by a
    port detection of the same class at IoU >= 0.5 (the heads' outputs
    differ by a few percent, so scores near the threshold or near a
    suppression flip)."""
    met = total = 0
    for (jd, (dets, valid, frame_idx, gval), _) in runs["dets"]:
        jdets, jvalid, jfi, jgv = jd
        np.testing.assert_array_equal(frame_idx.numpy(), jfi)
        np.testing.assert_array_equal(gval.numpy(), jgv)
        assert not valid.numpy()[~jgv].any()
        for b, k in zip(*np.nonzero(jgv)):
            t, j = dets.numpy()[b, k][valid.numpy()[b, k]], jdets[b, k][
                jvalid[b, k]]
            assert abs(len(t) - len(j)) <= 2
            if len(j) and len(t):
                iou = _iou(j[:, :4], t[:, :4])
                same = j[:, 6:7] == t[None, :, 6]
                met += int(((iou >= MATCH_IOU) & same).any(1).sum())
            total += len(j)
    assert total > 0 and met >= MATCHED * total, (met, total)
