"""NMS on the card's route without a card: ``csrc/nms_keep.cu``'s algorithm
(a greedy sweep over the score-sorted boxes, each box that is still alive
clearing the later ones it overlaps above the threshold) as plain torch
ops, fed every anchor with no 512-candidate branch and no host read,
against the JAX package's ``postprocess`` (its Jacobi ``while_loop`` and
its ``lax.cond``), bit for bit: more than 512 candidates in a frame,
suppression chains of depth 6, an IoU exactly at the threshold, 0 and 1
candidates, class-aware and class-agnostic, ``pre_nms_topk`` 0 and 100.
Also the port's plain route (Jacobi with its branch) against the sweep,
and its 512-candidate set against the all-anchor set. The kernel itself
is held against its plain version in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.ops.boxes import postprocess as j_postprocess
from rvt_tpu_torch.ops import boxes
from tests.test_torch_graphs import forbid_host_reads

A, C, CONF, MAX_DET = 1000, 2, 0.1, 300
CHAIN = 6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep_keep(nms_boxes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """``nms_keep.cu``'s sweep in torch ops (box i, if alive, clears each
    later j with iou(i, j) > thr), K steps of fixed shape: no host read."""
    K = nms_boxes.shape[-2]
    iou = boxes.pairwise_iou_xyxy(nms_boxes, nms_boxes)
    idx = torch.arange(K)
    clears = (iou > iou_threshold) & (idx[:, None] < idx[None, :])
    alive = valid.clone()
    for i in range(K):
        alive = alive & ~(clears[:, i] & alive[:, i:i + 1])
    return alive


def _predictions(seed: int) -> np.ndarray:
    """[4, A, 5 + C]: frame 0 with 600 candidates (above 512) and a chain
    of 6 boxes, each overlapping only its neighbours (IoU 7/13), in score
    order; frame 1 with 300 and a pair at IoU exactly 1/2; frame 2 with
    one candidate, frame 3 with none. Scores are distinct."""
    rng = np.random.RandomState(seed)
    B = 4
    pred = np.zeros((B, A, 5 + C), np.float32)
    pred[..., :2] = rng.uniform(0, 200, (B, A, 2))
    pred[..., 2:4] = rng.uniform(4, 40, (B, A, 2))
    pred[..., 4] = 0.01
    pred[..., 5:] = rng.uniform(0.3, 1.0, (B, A, C))
    for b, n in enumerate((600, 300, 1, 0)):
        on = rng.permutation(A)[:n]
        pred[b, on, 4] = rng.uniform(0.5, 0.98, n)
    # frame 0: the chain, class 0 (no offset), above every other score
    chain = np.flatnonzero(pred[0, :, 4] > 0.4)[:CHAIN]
    for k, a in enumerate(chain):
        pred[0, a, :4] = (100 + 3 * k, 50, 10, 10)
        pred[0, a, 4] = 0.999 - 0.001 * k
        pred[0, a, 5:] = (0.99, 0.1)
    # frame 1: xyxy (0, 0, 2, 1) then (0, 0, 1, 1): inter 1, union 2
    pair = np.flatnonzero(pred[1, :, 4] > 0.4)[:2]
    pred[1, pair[0], :5] = (1.0, 0.5, 2.0, 1.0, 0.999)
    pred[1, pair[1], :5] = (0.5, 0.5, 1.0, 1.0, 0.998)
    pred[1, pair, 5:] = (0.99, 0.1)
    return pred


def _jax(pred, thr, topk, agnostic):
    det, valid = j_postprocess(jnp.asarray(pred), num_classes=C,
                               conf_thre=CONF, nms_thre=thr,
                               pre_nms_topk=topk, max_detections=MAX_DET,
                               class_agnostic=agnostic)
    return np.asarray(det), np.asarray(valid)


def _sweep_route(monkeypatch, pred, thr, topk, agnostic):
    """The card's route: every anchor (or the top ``topk``) sorted, the
    sweep for the keep mask."""
    monkeypatch.setattr(boxes, "nms_keep",
                        lambda b, v, t, plain=False: sweep_keep(b, v, t))
    k = min(topk, A) if topk > 0 else A
    pred = torch.from_numpy(pred)
    with forbid_host_reads():
        det, valid = boxes._postprocess_k(pred, k, C, CONF, thr, MAX_DET,
                                          agnostic, False)
    return det.numpy(), valid.numpy()


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("topk", [0, 100])
@pytest.mark.parametrize("thr", [0.45, 0.5])
def test_sweep_over_every_anchor_matches_jax(monkeypatch, thr, topk,
                                             agnostic):
    pred = _predictions(0)
    jd, jv = _jax(pred, thr, topk, agnostic)
    td, tv = _sweep_route(monkeypatch, pred, thr, topk, agnostic)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)
    assert jv[2].sum() == 1 and jv[3].sum() == 0
    if topk == 0:
        # the chain keeps every other box; the pair at IoU 1/2 survives
        # a threshold of 1/2 and not 0.45
        kept0 = td[0][tv[0]]
        chain_x1 = [100 + 3 * k - 5 for k in range(CHAIN)]
        hits = [x for x in chain_x1 if np.any(kept0[:, 0] == x)
                and np.any(kept0[:, 1] == 45)]
        assert hits == chain_x1[::2]
        small = np.any((td[1][:, :4] == (0, 0, 1, 1)).all(-1) & tv[1])
        assert small == (thr == 0.5)


@pytest.mark.parametrize("agnostic", [False, True])
def test_plain_route_and_its_512_branch_match_the_sweep(monkeypatch,
                                                        agnostic):
    """The CPU's route (Jacobi, with its host-read branch) equals the card's
    all-anchor sweep; where no lane has more than 512 candidates the
    512-candidate set gives the all-anchor result bit for bit."""
    pred = _predictions(1)
    plain = boxes.postprocess(torch.from_numpy(pred), C, CONF, 0.45, 0,
                              MAX_DET, agnostic)
    few = torch.from_numpy(pred[1:])  # at most 300 candidates a frame
    k512 = boxes._postprocess_k(few, 512, C, CONF, 0.45, MAX_DET, agnostic,
                                True)
    kall = boxes._postprocess_k(few, A, C, CONF, 0.45, MAX_DET, agnostic,
                                True)
    for a, b in zip(k512, kall):
        assert torch.equal(a, b)
    sd, sv = _sweep_route(monkeypatch, pred, 0.45, 0, agnostic)
    np.testing.assert_array_equal(plain[1].numpy(), sv)
    np.testing.assert_array_equal(plain[0].numpy(), sd)
    # JAX's 512-candidate branch (no lane above 512) against the sweep
    jd, jv = _jax(pred[1:], 0.45, 0, agnostic)
    sd, sv = _sweep_route(monkeypatch, pred[1:], 0.45, 0, agnostic)
    np.testing.assert_array_equal(sv, jv)
    np.testing.assert_array_equal(sd, jd)


def test_jacobi_plain_version_equals_the_sweep():
    """``nms_keep_plain`` (the kernel's plain version) and the sweep give
    the same mask on dense random frames, chains of overlapping boxes
    among them."""
    rng = np.random.RandomState(2)
    B, K = 3, 400
    xy = rng.uniform(0, 60, (B, K, 2)).astype(np.float32)
    wh = rng.uniform(2, 20, (B, K, 2)).astype(np.float32)
    b = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    valid = torch.arange(K)[None, :] < torch.tensor([[K], [250], [0]])
    for thr in (0.3, 0.45, 0.7):
        assert torch.equal(boxes.nms_keep_plain(b, valid, thr),
                           sweep_keep(b, valid, thr))
    assert boxes.nms_keep(b, valid, 0.45).dtype == torch.bool
