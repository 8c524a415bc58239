"""The port's validation path (rvt_tpu_torch.training.evaluator_loop,
convert/torch_ckpt.py, cli/validate.py, tools/run_gate.py) on the CPU
against the JAX package's, over recordings that the JAX package's
preprocess writes in the production layout (tests/test_eval_loop.py).
gen1 tiny at (64, 80), T = 5, f32 on the module path; weights from JAX's
``init_detector`` through the weight bridge. On these sparse recordings
every score of the random head lies within 2 % of its prior, 1e-4: the
confidence threshold of 1e-4 lets 79-97 of the 126 anchors of a frame
into NMS (at 2e-4 none would enter)."""
import json
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from rvt_tpu.config import preset as j_preset
from rvt_tpu.data.sequence import Recording as JRecording
from rvt_tpu.data.sequence import StreamView as JStreamView
from rvt_tpu.data.streaming import EvalStreamScheduler as JScheduler
from rvt_tpu.models import init_detector as j_init_detector
from rvt_tpu.training import evaluator_loop as j_loop
from rvt_tpu_torch.cli import validate as t_validate
from rvt_tpu_torch.config import preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.convert.torch_ckpt import load_torch_checkpoint
from rvt_tpu_torch.data.sequence import Recording, StreamView
from rvt_tpu_torch.data.streaming import EvalStreamScheduler
from rvt_tpu_torch.models.detector import RVTDetector
from rvt_tpu_torch.training import evaluator_loop as t_loop

from .test_eval_loop import make_mini_gen1_dataset

KW = dict(resolution_hw=(64, 80), sequence_length=5, max_labels_per_frame=8,
          max_labeled_frames=4)
CONF = 1e-4
STATS = ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(preset_fn, conf=CONF, **kw):
    cfg = preset_fn("gen1", "tiny", **dict(KW, **kw))
    return replace(cfg, model=replace(cfg.model, postprocess=replace(
        cfg.model.postprocess, confidence_threshold=conf)))


def _capture(monkeypatch, module):
    """Record the PropheseeEvaluator that ``module``'s loop makes."""
    made = []

    class Recorded(module.PropheseeEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, "PropheseeEvaluator", Recorded)
    return made


def _views(rec_cls, view_cls, data, cfg):
    return [view_cls(rec_cls(p, cfg.dataset.ev_repr_name,
                             original_hw=cfg.dataset.resolution_hw,
                             max_labels_per_frame=cfg.dataset.max_labels_per_frame),
                     cfg.dataset.sequence_length)
            for p in sorted(data.iterdir())]


def make_boxed_dataset(root, names=("a", "b"), hw=(64, 80)):
    """Recordings as ``make_mini_gen1_dataset`` writes them (JAX's
    preprocess, the production layout; the same events), with three 32x32
    boxes a label frame, two of them where the random head's stride-32
    boxes lie (centred on the cells' corners), so that some detections
    match and the stats are not all zero."""
    import h5py

    from rvt_tpu.cli import preprocess as pp

    from .test_data_pipeline import BBOX_DTYPE

    H, W = hw
    raw = root / "raw"
    raw.mkdir(exist_ok=True)
    old = pp.DATASET_HW["gen1"]
    pp.DATASET_HW["gen1"] = (H, W)
    try:
        for i, name in enumerate(names):
            rng = np.random.RandomState(i)
            n = 80_000
            t = np.sort(rng.randint(0, 2_500_000, n)).astype(np.int64)
            ev = dict(x=rng.randint(0, W, n).astype(np.uint16),
                      y=rng.randint(0, H, n).astype(np.uint16),
                      p=rng.randint(0, 2, n).astype(np.int8), t=t)
            h5f = raw / f"{name}_td.dat.h5"
            with h5py.File(str(h5f), "w") as f:
                g = f.create_group("events")
                for k, v in ev.items():
                    g.create_dataset(k, data=v)
                g.create_dataset("height", data=H)
                g.create_dataset("width", data=W)
            label_ts = np.arange(600_000, 2_500_000, 250_000, dtype=np.int64)
            rows = [(ts, x, y, 32.0, 32.0, c, 0, 1.0) for ts in label_ts
                    for x, y, c in ((16.0, 16.0, 0), (48.0, 16.0, 1),
                                    (24.0, 28.0, 1))]
            npy = raw / f"{name}_bbox.npy"
            np.save(str(npy), np.array(rows, dtype=BBOX_DTYPE))
            assert pp.process_recording(npy, h5f, root / "val" / name,
                                        "gen1", "val")
    finally:
        pp.DATASET_HW["gen1"] = old
    return root / "val"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dataset, JAX's weights and both loops' results (metrics, the
    evaluator's buffers, the panels), and the weights as an upstream
    Lightning checkpoint."""
    root = tmp_path_factory.mktemp("eval_loop")
    data = make_boxed_dataset(root)
    jcfg, cfg = _cfg(j_preset), _cfg(preset)
    jmodel, variables = j_init_detector(jcfg.model, jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    model = RVTDetector(cfg.model).eval()
    model.load_state_dict(from_flax(variables), strict=True)
    ckpt = root / "rvt-t.ckpt"
    torch.save({"state_dict": {f"mdl.{k}": v
                               for k, v in model.state_dict().items()},
                "epoch": 3}, str(ckpt))
    out = dict(data=data, cfg=cfg, variables=variables, model=model,
               ckpt=ckpt)
    with pytest.MonkeyPatch.context() as mp:
        made = _capture(mp, j_loop)
        out["j_metrics"] = j_loop.run_streaming_eval(
            jmodel, variables, jcfg,
            iter(JScheduler(_views(JRecording, JStreamView, data, jcfg), B)),
            B, viz_dir=root / "j_viz", viz_every=3)
        out["j_eval"] = made[-1]
        made = _capture(mp, t_loop)
        out["t_metrics"] = t_loop.run_streaming_eval(
            model, cfg,
            iter(EvalStreamScheduler(_views(Recording, StreamView, data,
                                            cfg), B)),
            B, viz_dir=root / "t_viz", viz_every=3, device="cpu")
        out["t_eval"] = made[-1]
    out["j_viz"], out["t_viz"] = root / "j_viz", root / "t_viz"
    return out


def test_gt_buffers_equal_jax(world):
    j, t = world["j_eval"], world["t_eval"]
    assert len(t._labels) == len(j._labels) > 0
    for a, b in zip(t._labels, j._labels):
        np.testing.assert_array_equal(a, b)


def _canonical(p):
    """Detection rows in a fixed order: by box corner and size, rounded to
    the pixel (each anchor's box lies at its own place); the score order
    of near-tied rows is not part of the protocol's input."""
    key = np.round(np.stack([p["x"], p["y"], p["w"], p["h"]])).astype(int)
    return p[np.lexsort(key[::-1])]


def test_predictions_match_jax(world):
    """Rows equal in count per frame; boxes and scores within 1e-4 of
    max|ref|."""
    j, t = world["j_eval"], world["t_eval"]
    assert len(t._predictions) == len(j._predictions)
    counts = [len(p) for p in j._predictions]
    assert [len(p) for p in t._predictions] == counts
    assert sum(counts) > 0
    for a, b in zip(t._predictions, j._predictions):
        a, b = _canonical(a), _canonical(b)
        np.testing.assert_array_equal(a["t"], b["t"])
        np.testing.assert_array_equal(a["class_id"], b["class_id"])
        for f in ("x", "y", "w", "h", "class_confidence"):
            ref = b[f].astype(np.float64)
            scale = max(np.abs(ref).max(initial=0.0), 1e-6)
            assert np.abs(a[f] - ref).max(initial=0.0) <= 1e-4 * scale, f


def test_stats_match_jax(world):
    j, t = world["j_metrics"], world["t_metrics"]
    assert set(t) == set(STATS) == set(j)
    for k in STATS:
        assert np.isfinite(t[k])
        assert abs(t[k] - j[k]) <= 1e-4, k


def test_panels_equal_jax(world):
    """Every viz_every-th labelled frame, pixel for pixel as JAX's
    ``render_detections`` drew it."""
    jp = sorted(p.name for p in world["j_viz"].glob("frame_*.png"))
    assert jp and sorted(p.name for p in world["t_viz"].glob(
        "frame_*.png")) == jp
    for name in jp:
        a = np.asarray(Image.open(world["t_viz"] / name))
        b = np.asarray(Image.open(world["j_viz"] / name))
        assert a.shape == (64, 80, 3)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_too_many_labeled_frames_raise(world):
    cfg = _cfg(preset, max_labeled_frames=1)
    views = _views(Recording, StreamView, world["data"], cfg)
    with pytest.raises(ValueError, match="max_labeled_frames"):
        t_loop.run_streaming_eval(world["model"], cfg,
                                  iter(EvalStreamScheduler(views, B)), B,
                                  device="cpu")


def test_loop_raises_without_a_card(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_loop.run_streaming_eval(world["model"], world["cfg"], iter([]), B)


def test_serve_fused_config_runs_the_loop(world):
    """The kernels config (bf16, s2d stem, fused_kernels) on their plain
    versions: the host s2d transform feeds the step, the metrics come."""
    cfg = t_validate.serve_fused_config(world["cfg"])
    model = RVTDetector(cfg.model).eval()
    model.load_state_dict(world["model"].state_dict(), strict=True)
    views = _views(Recording, StreamView, world["data"], cfg)
    m = t_loop.run_streaming_eval(model, cfg,
                                  iter(EvalStreamScheduler(views, B)), B,
                                  device="cpu")
    assert set(m) == set(STATS) and all(np.isfinite(v) for v in m.values())


def test_checkpoint_loader_matches_jax(world):
    """The Lightning .ckpt loads into a fresh model bit for bit, and into
    JAX's variables bit for bit through JAX's converter: the two sides then
    score what the loops above scored. An unknown key raises."""
    from rvt_tpu.convert.torch_ckpt import load_torch_checkpoint as j_load

    model = load_torch_checkpoint(world["ckpt"],
                                  RVTDetector(world["cfg"].model)).eval()
    for (n, a), b in zip(model.state_dict().items(),
                         world["model"].state_dict().values()):
        assert torch.equal(a, b), n
    jv = j_load(str(world["ckpt"]))
    flat = dict(jax.tree_util.tree_flatten_with_path(jv)[0])
    ref = jax.tree_util.tree_flatten_with_path(world["variables"])[0]
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(flat[path], leaf, err_msg=str(path))
    cfg = world["cfg"]
    views = _views(Recording, StreamView, world["data"], cfg)
    m = t_loop.run_streaming_eval(model, cfg,
                                  iter(EvalStreamScheduler(views, B)), B,
                                  device="cpu")
    assert m == world["t_metrics"]

    bad = world["ckpt"].parent / "bad.pt"
    sd = {f"mdl.{k}": v for k, v in model.state_dict().items()}
    sd["mdl.backbone.stages.0.extra.weight"] = torch.zeros(1)
    torch.save(sd, str(bad))
    with pytest.raises(RuntimeError, match="extra"):
        load_torch_checkpoint(bad, RVTDetector(cfg.model))


def test_run_gate_matches_jax(world):
    """The port's gate and JAX's on the same checkpoint and recordings
    give the same record (the shipped 0.1 threshold: no detection)."""
    from rvt_tpu_torch.tools.run_gate import run_gate
    from tools.run_gate import run_gate as j_run_gate

    kw = dict(split="val", batch_size=B, expected_map=0.0,
              preset_kwargs=KW, skip_md5=True)
    data = world["data"].parent
    got = run_gate(world["ckpt"], data, "gen1", "tiny", device="cpu", **kw)
    ref = j_run_gate(world["ckpt"], data, "gen1", "tiny", **kw)
    assert got == ref
    assert got["num_recordings"] == 2 and got["gate_pass"] is True


def test_validate_cli_matches_jax(tmp_path, world, monkeypatch, capsys):
    """``cli.validate.main`` prints what ``rvt_tpu.cli.validate`` prints
    for the same checkpoint over one recording at the sensor's 240x304."""
    from rvt_tpu.cli import validate as j_validate

    root = tmp_path / "full"
    root.mkdir()
    make_mini_gen1_dataset(root, names=("c",), hw=(240, 304))
    args = ["--dataset", "gen1", "--size", "tiny", "--data_dir", str(root),
            "--checkpoint", str(world["ckpt"]), "--batch_size", "1"]
    t_validate.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["validate"] + args)
    j_validate.main()
    ref = capsys.readouterr().out
    assert got == ref
    assert set(json.loads(got)) == set(STATS)


def test_trainer_validation_best_slot(tmp_path, world):
    """``Trainer.fit`` with ``eval_fn`` = ``run_streaming_eval`` keeps the
    best slot, and the validate CLI's loader reads it back to the same
    metrics bit for bit (s2d stem, so the panels go through
    ``host_depth_to_space``)."""
    from tests.test_torch_trainer import batches, make_trainer, read_log
    from tests.test_torch_trainer import tiny_cfg

    cfg = tiny_cfg(conf=CONF)
    cfg = replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, stem_s2d=True)))
    views = _views(Recording, StreamView, world["data"], cfg)
    trainer = make_trainer(cfg, tmp_path / "run", max_steps=2,
                           val_every_n_steps=1, train_viz_dir=str(
                               tmp_path / "viz"),
                           detection_metrics_every_n_steps=2,
                           detection_metrics_n_batches=1)
    seen = []

    def eval_fn(model):
        m = t_loop.run_streaming_eval(
            model, cfg, iter(EvalStreamScheduler(views, B)), B,
            device="cpu")
        seen.append(m)
        return m

    trainer.fit(batches(cfg, 3), eval_fn=eval_fn)
    assert len(seen) == 2 and all(set(m) == set(STATS) for m in seen)
    vals = [l for l in read_log(tmp_path / "run") if "val/AP" in l]
    assert [l["step"] for l in vals] == [1, 2]
    best = trainer.ckpt.best_step()
    assert best in (1, 2)
    vcfg = replace(cfg, model=replace(cfg.model, compute_dtype=(
        trainer.model.cfg.compute_dtype)))
    model = t_validate.load_model(tmp_path / "run", vcfg, "cpu")
    m = t_loop.run_streaming_eval(model, vcfg,
                                  iter(EvalStreamScheduler(views, B)), B,
                                  device="cpu")
    assert m == seen[best - 1]
    panels = sorted((tmp_path / "viz").glob("step_0000002_*.png"))
    assert panels
    assert np.asarray(Image.open(panels[0])).shape == (64, 80, 3)


