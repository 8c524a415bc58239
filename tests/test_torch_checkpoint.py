"""The port's checkpoints (rvt_tpu_torch.utils.checkpoint and the
Trainer's save / restore), mirroring tests/test_trainer.py's: a restored
trainer holds the saved parameters, BatchNorm buffers, Adam moments and
step bit for bit, and the best checkpoint survives newer, worse steps."""
import json

import pytest
import torch

from rvt_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_trainer import batches, make_trainer, tiny_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(a, b):
    """Two trainers' parameters, buffers, moments and steps, bit for bit."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n
    assert any(n.endswith("running_var") for n in sa)
    for x, y in zip(a.optimizer.mu + a.optimizer.nu,
                    b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert a.optimizer.count == b.optimizer.count
    assert a._host_step == b._host_step


def test_restore_gives_back_the_saved_state(tmp_path):
    cfg = tiny_cfg()
    trainer = make_trainer(cfg, tmp_path, max_steps=2, ckpt_every_n_steps=2)
    trainer.fit(batches(cfg, 3))
    fresh = make_trainer(cfg, tmp_path)
    assert fresh.ckpt.latest_step() == 2
    assert fresh.optimizer.count == 0
    assert fresh.restore()
    assert_same_state(trainer, fresh)
    # and it trains on: one more step from the restored state
    fresh.tcfg.max_steps = 3
    m = fresh.fit(batches(cfg, 1, seed=1))
    assert fresh._host_step == 3 and m["loss"] > 0


def test_restore_without_a_checkpoint(tmp_path):
    assert not make_trainer(tiny_cfg(), tmp_path).restore()


def _state(v):
    return {"w": torch.full((4,), float(v)), "step": int(v)}


def test_best_checkpoint_survives_worse_steps(tmp_path):
    """The best monitored metric (a maximum) keeps its step restorable
    while the recency window moves on (reference ModelCheckpoint top-1,
    callbacks/custom.py:8-31)."""
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr.save(_state(1), step=1, metric=0.3)
    mgr.save(_state(2), step=2, metric=0.5)   # best
    mgr.save(_state(3), step=3, metric=0.2)
    mgr.save(_state(4), step=4, metric=0.1)   # recency window: {3, 4}
    assert mgr.best_step() == 2
    assert mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "ckpt" / "steps").iterdir()) \
        == ["3", "4"]
    assert torch.equal(mgr.restore_best()["w"], torch.full((4,), 2.0))
    assert torch.equal(mgr.restore()["w"], torch.full((4,), 4.0))
    assert mgr.restore(3)["step"] == 3
    meta = json.loads((tmp_path / "ckpt" / "best.json").read_text())
    assert meta == {"best": 0.5, "step": 2, "monitor": "AP"}
    # a fresh manager on the same directory resumes the best watermark
    mgr2 = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr2.save(_state(5), step=5, metric=0.4)  # worse: best unchanged
    assert mgr2.best_step() == 2
    mgr2.save(_state(6), step=6, metric=0.6)  # better: the one best slot
    assert mgr2.best_step() == 6
    assert [p.name for p in (tmp_path / "ckpt" / "best").iterdir()] == ["6"]


@pytest.mark.parametrize("keep", [1, 3])
def test_keep_most_recent(tmp_path, keep):
    mgr = CheckpointManager(tmp_path, keep=keep)
    for s in range(1, 5):
        mgr.save(_state(s), step=s)
    assert sorted(int(p.name) for p in (tmp_path / "steps").iterdir()) == \
        list(range(5 - keep, 5))
    assert mgr.best_step() is None and mgr.restore_best() is None
