"""The port's training CLI (rvt_tpu_torch.cli.train) on the CPU, over
recordings that the JAX package's preprocess writes
(tests/test_torch_train_data.py:make_train_set) at gen1 geometry shrunk
to (64, 80), T = 5: the batches of ``build_train_scheduler`` and of the
port's ``main`` equal, bit for bit, those of the scheduler that
``rvt_tpu.cli.train.main`` builds, for the three samplings, serially and
with 2 workers; ``main`` trains gen1 tiny a step, validates, writes and
publishes a checkpoint, resumes from it and from the artifact registry;
``--init_ckpt`` loads strictly; the options a run cannot take raise."""
import ast
import itertools
import json
import math
from dataclasses import fields, replace

import numpy as np
import pytest
import torch

import rvt_tpu.config as j_config
import rvt_tpu.training.trainer as j_trainer
import rvt_tpu_torch.config as t_config
import rvt_tpu_torch.training.trainer as t_trainer
from rvt_tpu.cli import train as j_train
from rvt_tpu_torch.cli import train as t_train
from rvt_tpu_torch.models.detector import init_detector
from rvt_tpu_torch.utils.checkpoint import CheckpointManager

from .test_torch_train_data import make_train_set

KW = dict(resolution_hw=(64, 80), sequence_length=5, max_labels_per_frame=8)
N_BATCHES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_train_set(tmp_path_factory.mktemp("cli_set"))


def small_presets(monkeypatch, **kw):
    """Both packages' ``preset`` at the test geometry (the CLIs import it
    when ``main`` runs)."""
    for mod in (j_config, t_config):
        real = mod.preset
        monkeypatch.setattr(mod, "preset", lambda d, s, _real=real, **o:
                            _real(d, s, **dict(KW, **kw, **o)))


def capture_fit(monkeypatch, module):
    """Replace ``module.Trainer`` by one whose ``fit`` keeps the first
    ``N_BATCHES`` batches it is fed; returns that list."""
    got = []

    class Capture:
        def __init__(self, *a, **k):
            pass

        def fit(self, batches, eval_fn=None):
            got.extend(itertools.islice(batches, N_BATCHES))
            return {}

    monkeypatch.setattr(module, "Trainer", Capture)
    return got


def _same_batch(a, b) -> None:
    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("sampling", ["stream", "random", "mixed"])
def test_train_batches_equal_jax_main(data, monkeypatch, sampling, workers):
    small_presets(monkeypatch, train_sampling=sampling)
    args = ["--dataset", "gen1", "--size", "tiny", "--data_dir", str(data),
            "--batch_size", "4", "--seed", "3", "--num_workers",
            str(workers)]
    ref = capture_fit(monkeypatch, j_trainer)
    monkeypatch.setattr("sys.argv", ["train"] + args)
    j_train.main()
    via_main = capture_fit(monkeypatch, t_trainer)
    t_train.main(args + ["--device", "cpu"])
    cfg = t_config.preset("gen1", "tiny")
    cfg = replace(cfg, batch_size=replace(cfg.batch_size, train=4, eval=4))
    sched = t_train.build_train_scheduler(
        cfg, t_train.open_recordings(data, "train", cfg), seed=3,
        num_workers=workers)
    direct = list(itertools.islice(iter(sched), N_BATCHES))
    assert len(ref) == len(via_main) == len(direct) == N_BATCHES
    for a, b, c in zip(direct, via_main, ref):
        _same_batch(a, b)
        _same_batch(a, c)
        assert a.ev_repr.shape == (4, 5, 64, 80, 20)
    n_random = {"stream": 0, "random": 4, "mixed": 2}[sampling]
    if n_random:
        assert all(b.is_first_sample[-n_random:].all() for b in direct)


def _metrics(out):
    """The dict ``main`` prints last."""
    return ast.literal_eval(out.strip().splitlines()[-1])


def test_main_trains_validates_and_resumes(data, tmp_path, monkeypatch,
                                           capsys):
    """One gen1-tiny step with validation after it: a checkpoint in the
    run's directory, published to the registry, finite metrics printed.
    Then ``--resume_artifact`` into a fresh directory and ``--resume``
    from the first one each take step 2 from step 1's state."""
    small_presets(monkeypatch)
    base = ["--dataset", "gen1", "--size", "tiny", "--data_dir", str(data),
            "--batch_size", "2", "--log_every", "1", "--device", "cpu"]
    run, reg = tmp_path / "run", tmp_path / "registry"
    t_train.main(base + ["--max_steps", "1", "--val_every", "1",
                         "--ckpt_dir", str(run), "--artifact_dir", str(reg)])
    m = _metrics(capsys.readouterr().out)
    assert {"loss", "grad_norm", "train/frames_per_s"} <= set(m)
    assert all(math.isfinite(v) for v in m.values())
    lines = [json.loads(x) for x in (run / "metrics.jsonl").read_text()
             .splitlines()]
    assert any("val/AP" in x and x["step"] == 1 for x in lines)
    mgr = CheckpointManager(run)
    assert mgr.latest_step() == 1
    step1 = mgr.restore(map_location="cpu")
    assert step1["step"] == 1
    for extra, logged in (
            (["--resume_artifact", "checkpoint@last", "--artifact_dir",
              str(reg), "--ckpt_dir", str(tmp_path / "fresh")], [2]),
            (["--resume", "--ckpt_dir", str(run)], [1, 1, 2])):
        t_train.main(base + ["--max_steps", "2"] + extra)
        assert math.isfinite(_metrics(capsys.readouterr().out)["loss"])
        log = tmp_path / extra[-1] / "metrics.jsonl"
        assert [json.loads(x)["step"]
                for x in log.read_text().splitlines()] == logged
    with pytest.raises(SystemExit):
        t_train.main(base + ["--resume_artifact", "checkpoint@last"])
    with pytest.raises(FileNotFoundError):
        t_train.main(base + ["--resume", "--ckpt_dir", str(tmp_path / "x")])


def test_init_ckpt_loads_strictly(data, tmp_path, monkeypatch):
    """``--init_ckpt`` puts an upstream-layout checkpoint's weights into
    the trainer's model bit for bit; one key more or one key less
    raises."""
    small_presets(monkeypatch)
    cfg = t_config.preset("gen1", "tiny")
    src = init_detector(cfg.model, seed=7, device="cpu").state_dict()
    seen = []
    monkeypatch.setattr(t_trainer.Trainer, "fit",
                        lambda self, b, eval_fn=None:
                        seen.append(self.model.state_dict()) or {})
    base = ["--dataset", "gen1", "--size", "tiny", "--data_dir", str(data),
            "--device", "cpu", "--ckpt_dir", str(tmp_path / "run")]
    good = tmp_path / "rvt-t.ckpt"
    torch.save({"state_dict": {"mdl." + k: v for k, v in src.items()}}, good)
    t_train.main(base + ["--init_ckpt", str(good)])
    assert seen[0].keys() == src.keys()
    for k in src:
        assert torch.equal(seen[0][k], src[k]), k
    fresh = init_detector(cfg.model, seed=0, device="cpu").state_dict()
    assert any(not torch.equal(fresh[k], src[k]) for k in src)
    extra = dict(src, **{"fpn.extra.weight": torch.zeros(1)})
    missing = {k: v for k, v in src.items() if k != next(iter(src))}
    for i, sd in enumerate((extra, missing)):
        bad = tmp_path / f"bad{i}.ckpt"
        torch.save({"state_dict": {"mdl." + k: v for k, v in sd.items()}},
                   bad)
        with pytest.raises(RuntimeError, match="key"):
            t_train.main(base + ["--init_ckpt", str(bad)])


@pytest.mark.parametrize("flags,error,match", [
    (["--dp_size", "2"], ValueError, "has 1 process"),
    (["--multihost"], RuntimeError, "missing RANK, WORLD_SIZE, LOCAL_RANK"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
], ids=["dp_size", "multihost", "no_card"])
def test_unported_options_raise(data, tmp_path, monkeypatch, flags, error,
                                match):
    """The options this run cannot take raise: ``--dp_size 2`` in a world
    of one process (launch two), ``--multihost`` without torchrun's
    environment (naming what is missing), and ``--device cuda`` (the
    default) where no card is present (this host has none)."""
    if torch.cuda.is_available() and "cuda" in flags:
        pytest.skip("a CUDA device is present")
    small_presets(monkeypatch)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    args = ["--dataset", "gen1", "--data_dir", str(data), "--ckpt_dir",
            str(tmp_path / "run")]
    if "--device" not in flags:
        args += ["--device", "cpu"]
    with pytest.raises(error, match=match):
        t_train.main(args + flags)
