"""The port's checkpoint-artifact registry (rvt_tpu_torch.utils.artifacts),
mirroring tests/test_artifacts.py, with tests of its three repaired
hazards: concurrent publishers get distinct versions and keep both
aliases, prune drops the lowest scores first (a metric to maximise), and
the trainer's ``restore_from_artifact`` replaces a stale local copy."""
import multiprocessing as mp
import tarfile

import numpy as np
import pytest
import torch

from rvt_tpu_torch.utils.artifacts import ArtifactRegistry


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_publish_resolve_roundtrip(tmp_path):
    reg = ArtifactRegistry(tmp_path / "reg")
    src = tmp_path / "model.ckpt"
    src.write_bytes(b"weights-v1")
    assert reg.publish(src, "ckpt", score=0.31, step=100,
                       aliases=["last"]) == "ckpt@v1"
    payload, manifest = reg.resolve("ckpt@v1")
    assert payload.read_bytes() == b"weights-v1"
    assert manifest["score"] == pytest.approx(0.31)
    assert manifest["step"] == 100
    src.write_bytes(b"weights-v2")
    reg.publish(src, "ckpt", score=0.35, step=200, aliases=["last", "best"])
    for uri in ("ckpt@last", "ckpt@best", "ckpt"):
        payload, manifest = reg.resolve(uri)
        assert payload.read_bytes() == b"weights-v2", uri
        assert manifest["version"] == 2
    assert reg.resolve("ckpt@v1")[0].read_bytes() == b"weights-v1"
    with pytest.raises(KeyError):
        reg.resolve("ckpt@nope")
    with pytest.raises(FileNotFoundError):
        reg.resolve("other")


def test_publish_directory_and_md5_verify(tmp_path):
    reg = ArtifactRegistry(tmp_path / "reg")
    src = tmp_path / "step_10"
    (src / "sub").mkdir(parents=True)
    (src / "a.bin").write_bytes(b"aaa")
    (src / "sub" / "b.bin").write_bytes(b"bbb")
    reg.publish(src, "ckpt", step=10, aliases=["last"])
    payload, manifest = reg.resolve("ckpt")
    assert sorted(manifest["files"]) == ["a.bin", "sub/b.bin"]
    (payload / "a.bin").write_bytes(b"evil")
    with pytest.raises(IOError, match="md5"):
        reg.resolve("ckpt")
    assert reg.resolve("ckpt", verify=False)[1]["step"] == 10


def test_prune_keeps_topk_and_aliased(tmp_path):
    """Top-k by score survive, aliased versions are never deleted,
    unscored versions go (reference _rm_but_top_k)."""
    reg = ArtifactRegistry(tmp_path / "reg")
    src = tmp_path / "m.ckpt"
    for i, s in enumerate([0.10, 0.30, None, 0.20, 0.25]):
        src.write_bytes(f"w{i}".encode())
        reg.publish(src, "ckpt", score=s, step=i,
                    aliases=["last"] + (["best"] if s == 0.30 else []))
    assert sorted(reg.prune("ckpt", keep_top_k=2)) == [1, 3, 4]
    assert [m["version"] for m in reg.versions("ckpt")] == [2, 5]
    assert reg.resolve("ckpt@best")[1]["version"] == 2
    assert reg.resolve("ckpt@last")[1]["version"] == 5
    assert reg.prune("ckpt", keep_top_k=-1) == []


@pytest.mark.parametrize("keep,deleted", [(2, [2]), (1, [2, 3])])
def test_prune_drops_the_lowest_scores_first(tmp_path, keep, deleted):
    """The monitored metric is one to maximise: the lowest score goes
    first, the highest stays."""
    reg = ArtifactRegistry(tmp_path / "reg")
    src = tmp_path / "m.ckpt"
    for i, s in enumerate([0.5, 0.1, 0.3]):
        src.write_bytes(f"w{i}".encode())
        reg.publish(src, "ckpt", score=s, step=i)
    assert sorted(reg.prune("ckpt", keep_top_k=keep)) == deleted
    assert 1 in [m["version"] for m in reg.versions("ckpt")]


def _publisher(root, src, tag, n, barrier, out):
    reg = ArtifactRegistry(root)
    barrier.wait()
    out.put([reg.publish(src, "ckpt", step=i, aliases=[f"{tag}{i}"])
             for i in range(n)])


def test_concurrent_publishers_get_distinct_versions(tmp_path):
    """Two processes publish at once: every version number is taken once,
    and every alias either set survives (the read-modify-write of
    aliases.json runs under the lock)."""
    src = tmp_path / "m.ckpt"
    src.write_bytes(b"weights")
    ctx = mp.get_context("spawn")
    barrier, out = ctx.Barrier(2), ctx.Queue()
    n = 12
    procs = [ctx.Process(target=_publisher, args=(tmp_path / "reg", src, tag,
                                                  n, barrier, out))
             for tag in ("a", "b")]
    for p in procs:
        p.start()
    uris = out.get(timeout=120) + out.get(timeout=120)
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    assert len(set(uris)) == 2 * n
    reg = ArtifactRegistry(tmp_path / "reg")
    assert sorted(m["version"] for m in reg.versions("ckpt")) == list(
        range(1, 2 * n + 1))
    aliases = reg.aliases("ckpt")
    assert set(aliases) == {f"{t}{i}" for t in "ab" for i in range(n)}
    assert sorted(aliases.values()) == list(range(1, 2 * n + 1))


def test_publish_code_snapshot(tmp_path):
    reg = ArtifactRegistry(tmp_path / "reg")
    repo = tmp_path / "repo"
    (repo / "pkg").mkdir(parents=True)
    (repo / "pkg" / "mod.py").write_text("x = 1\n")
    (repo / "native.cpp").write_text("int main(){}\n")
    (repo / "data.bin").write_bytes(b"\x00" * 10)
    reg.publish_code(repo, name="code")
    payload, _ = reg.resolve("code")
    with tarfile.open(payload) as tar:
        assert sorted(tar.getnames()) == ["native.cpp", "pkg/mod.py"]


@pytest.fixture
def published(tmp_path):
    """A trainer that trained 2 steps and published its step-2
    checkpoint. (The trainer helpers are imported in the tests that use
    them: the publishers above run in spawned processes, which import
    this module.)"""
    from tests.test_torch_trainer import batches, make_trainer, tiny_cfg

    cfg = tiny_cfg()
    reg_dir = tmp_path / "registry"
    trainer = make_trainer(cfg, tmp_path / "a", max_steps=2,
                           ckpt_every_n_steps=2, artifact_dir=str(reg_dir),
                           artifact_top_k=1)
    trainer.fit(batches(cfg, 3))
    return cfg, reg_dir, trainer


def test_trainer_publish_and_restore_from_artifact(tmp_path, published):
    """A fresh trainer with a fresh checkpoint directory restores the
    published state bit for bit from the registry alone."""
    from tests.test_torch_checkpoint import assert_same_state
    from tests.test_torch_trainer import make_trainer

    cfg, reg_dir, trainer = published
    reg = ArtifactRegistry(reg_dir)
    assert reg.versions("checkpoint-code")
    vs = reg.versions("checkpoint")
    assert [m["step"] for m in vs] == [2]
    assert reg.aliases("checkpoint")["last"] == vs[0]["version"]
    fresh = make_trainer(cfg, tmp_path / "b", artifact_dir=str(reg_dir))
    assert fresh.restore_from_artifact("checkpoint@last")
    assert_same_state(trainer, fresh)


def test_restore_from_artifact_replaces_a_stale_local_copy(tmp_path,
                                                           published):
    """A local step directory that differs from the manifest (here a
    corrupted state file) is copied again, not restored as it is."""
    from tests.test_torch_checkpoint import assert_same_state
    from tests.test_torch_trainer import make_trainer

    cfg, reg_dir, trainer = published
    fresh = make_trainer(cfg, tmp_path / "c", artifact_dir=str(reg_dir))
    stale = fresh.ckpt.step_dir(2)
    stale.mkdir(parents=True)
    state = trainer.state_dict()
    state["model"] = {k: torch.zeros_like(v)
                      for k, v in state["model"].items()}
    torch.save(state, stale / "state.pt")
    assert fresh.restore_from_artifact("checkpoint@last")
    assert_same_state(trainer, fresh)
    w = next(iter(fresh.model.parameters()))
    assert bool(np.any(w.detach().numpy() != 0))
