"""The port's Trainer (rvt_tpu_torch.training.trainer), the kernels' plain
versions on the CPU at gen1 tiny (64, 80), T = 2, B = 2: its fit loop
against the train step driven by hand, its cadences (logging, gradflow,
train-time detection metrics), token-mask normalisation, its refusals,
weights from flax variables, and the prefetcher. Mirrors
tests/test_trainer.py."""
import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.config import preset as j_preset
from rvt_tpu.models import RVTDetector as JRVTDetector
from rvt_tpu.models.backbone import zero_states as j_zero_states
from rvt_tpu.models.detector import model_input_hw_c
from rvt_tpu_torch.config import preset
from rvt_tpu_torch.data.prefetch import PrefetchIterator
from rvt_tpu_torch.data.types import Batch
from rvt_tpu_torch.models import detector as det
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import init_detector
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import make_train_step
from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LOSS_KEYS = ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg",
             "grad_norm")


def tiny_cfg(masked=False, conf=None, preset_fn=preset):
    """gen1 tiny on the train kernels (fused_kernels; the trainer takes
    bf16 compute from training.precision)."""
    cfg = preset_fn("gen1", "tiny", resolution_hw=(64, 80),
                    sequence_length=2, max_labels_per_frame=4,
                    max_labeled_frames=2)
    pp = cfg.model.postprocess
    return replace(cfg, model=replace(
        cfg.model,
        backbone=replace(cfg.model.backbone, fused_kernels=True,
                         enable_masking=masked),
        postprocess=replace(pp, confidence_threshold=(
            pp.confidence_threshold if conf is None else conf))))


def batches(cfg, n, B=2, seed=0, token_masks=False):
    """``n`` windows of random events, one box on each lane's last frame
    at t = 1 s (past the Prophesee protocol's 0.5 s warm-up)."""
    rng = np.random.RandomState(seed)
    T = cfg.dataset.sequence_length
    H, W = cfg.dataset.dataloading_hw
    M = cfg.dataset.max_labels_per_frame
    ps = cfg.model.backbone.stem_patch_size
    for i in range(n):
        labels = np.zeros((B, T, M, 7), np.float32)
        label_mask = np.zeros((B, T, M), bool)
        labels[:, -1, 0] = (1_000_000.0, 8.0, 8.0, 30.0, 24.0, 0.0, 1.0)
        label_mask[:, -1, 0] = True
        yield Batch(
            ev_repr=rng.randint(0, 4, size=(B, T, H, W, 20)).astype(np.uint8),
            labels=labels, label_mask=label_mask,
            frame_valid=label_mask.any(-1),
            is_first_sample=np.full((B,), i == 0),
            is_padded=np.zeros((B, T), bool),
            token_mask=(rng.rand(B, T, H // ps, W // ps) < 0.2
                        if token_masks else None))


def make_trainer(cfg, path, **kw):
    kw = dict(dict(max_steps=3, log_every_n_steps=1, ckpt_every_n_steps=100,
                   gradflow_every_n_steps=0, prefetch_depth=2,
                   ckpt_dir=str(path)), **kw)
    return Trainer(cfg, TrainerConfig(**kw), device="cpu")


def read_log(path):
    return [json.loads(line) for line in
            (path / "metrics.jsonl").read_text().splitlines()]


def _by_hand(cfg, items, seed=0):
    """The train step driven by hand from the trainer's seed."""
    model = init_detector(replace(cfg.model, compute_dtype="bfloat16"),
                          seed=seed, device="cpu")
    opt = make_optimizer(model.parameters(), cfg.training)
    step = make_train_step(model, cfg, opt)
    states = zero_states(cfg.model.backbone, items[0].batch_size,
                         device="cpu")
    out = []
    for b in items:
        tm = None if b.token_mask is None else torch.from_numpy(b.token_mask)
        if tm is None and cfg.model.backbone.enable_masking:
            ps = cfg.model.backbone.stem_patch_size
            B, T, H, W = b.ev_repr.shape[:4]
            tm = torch.zeros(B, T, H // ps, W // ps, dtype=torch.bool)
        states, m = step(states, *(torch.from_numpy(a) for a in (
            b.ev_repr, b.labels, b.label_mask, b.frame_valid,
            b.is_first_sample)), tm)
        out.append({k: float(v) for k, v in m.items()})
    return model, opt, out


@pytest.mark.parametrize("masked,token_masks",
                         [(False, False), (True, False), (True, True)],
                         ids=["plain", "masked-none", "masked"])
def test_fit_matches_the_step_by_hand(tmp_path, masked, token_masks):
    """Three steps of ``fit`` log, bit for bit, the metrics of the train
    step driven by hand from the same seed, and leave the same weights
    and moments; with a masking model and batches without masks, the
    trainer feeds all-False masks."""
    cfg = tiny_cfg(masked=masked)
    items = list(batches(cfg, 4, token_masks=token_masks))
    trainer = make_trainer(cfg, tmp_path)
    last = trainer.fit(iter(items))
    model, opt, ref = _by_hand(cfg, items[:3])
    lines = read_log(tmp_path)
    assert [l["step"] for l in lines] == [1, 2, 3]
    for line, r in zip(lines, ref):
        for k in LOSS_KEYS:
            assert line[f"train/{k}"] == r[k], k
    assert {k: last[k] for k in LOSS_KEYS} == {k: ref[-1][k]
                                              for k in LOSS_KEYS}
    assert trainer._host_step == 3 == trainer.optimizer.count
    for (n, a), b in zip(trainer.model.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(trainer.optimizer.mu + trainer.optimizer.nu,
                    opt.mu + opt.nu):
        assert torch.equal(a, b)


def test_gradflow_on_its_cadence(tmp_path):
    cfg = tiny_cfg()
    trainer = make_trainer(cfg, tmp_path, gradflow_every_n_steps=2)
    trainer.fit(batches(cfg, 3))
    lines = read_log(tmp_path)
    gf = [l for l in lines if any(k.startswith("train/gradflow/")
                                  for k in l)]
    assert [l["step"] for l in gf] == [2]
    names = [n for n, _ in trainer.model.named_parameters()]
    for kind in ("gradflow", "weights"):
        vals = [gf[0][f"train/{kind}/{n}"] for n in names]
        assert all(np.isfinite(v) and v >= 0 for v in vals)
    assert set(trainer._steps) == {(False, False), (False, True)}


def test_detection_cadence_logs_train_ap(tmp_path):
    """train/AP on every 2nd step, from the detection variant run on the
    last 2 steps of each period (the confidence threshold 0: random
    weights score near the head's prior)."""
    cfg = tiny_cfg(conf=0.0)
    trainer = make_trainer(cfg, tmp_path, max_steps=4, log_every_n_steps=10,
                           detection_metrics_every_n_steps=2,
                           detection_metrics_n_batches=2)
    trainer.fit(batches(cfg, 5))
    ap = [l for l in read_log(tmp_path) if "train/AP" in l]
    assert [l["step"] for l in ap] == [2, 4]
    assert all(np.isfinite(l["train/AP"]) for l in ap)
    assert set(trainer._steps) == {(False, False), (True, False)}


def test_fit_refusals(tmp_path):
    cfg = tiny_cfg()
    # dp_size counts processes: 2 in a world of one raises, saying how
    # many to launch
    with pytest.raises(ValueError, match="launch dp_size processes"):
        Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path)), dp_size=2,
                device="cpu")
    # train_viz_dir: panels of the evaluated step's labelled frames, each
    # as JAX's render_detections draws that frame
    from PIL import Image

    from rvt_tpu.utils.visualization import LABELMAP_GEN1, render_detections

    vcfg = tiny_cfg(conf=0.0)
    vt = make_trainer(vcfg, tmp_path / "viz_run", max_steps=2,
                      log_every_n_steps=10, detection_metrics_every_n_steps=2,
                      detection_metrics_n_batches=1,
                      train_viz_dir=str(tmp_path / "viz"))
    drawn = []
    write = vt._write_train_panels
    vt._write_train_panels = lambda *a: (drawn.append(a), write(*a))
    vt.fit(batches(vcfg, 2))
    (batch, frames, step), = drawn
    panels = sorted((tmp_path / "viz").glob("step_*.png"))
    assert step == 2 and len(panels) == len(frames) == 2
    for path, (b, t_step, gt, pred) in zip(panels, frames):
        ref = render_detections(np.moveaxis(batch.ev_repr[b, t_step], -1, 0),
                                gt, pred, LABELMAP_GEN1)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), ref)
    # the shipped preset (fused_kernels off) trains on the module path,
    # in the bf16 that training.precision asks for; dropout refuses as in
    # JAX's train step
    shipped = preset("gen1", "tiny", resolution_hw=(64, 80),
                     sequence_length=2, max_labels_per_frame=4,
                     max_labeled_frames=2)
    st = make_trainer(shipped, tmp_path / "shipped", max_steps=1)
    assert st.model.cfg.compute_dtype == "bfloat16"
    assert det.stage_routes(st.model.cfg, "train") == ["modules"] * 4
    st.fit(batches(shipped, 1))
    assert np.isfinite(read_log(tmp_path / "shipped")[-1]["train/loss"])
    drop = replace(shipped, model=replace(shipped.model, backbone=replace(
        shipped.model.backbone, lstm=replace(
            shipped.model.backbone.lstm, drop_cell_update=0.1))))
    with pytest.raises(NotImplementedError, match="drop_cell_update"):
        make_trainer(drop, tmp_path / "drop")
    trainer = make_trainer(cfg, tmp_path)
    # a window with more labelled frames than max_labeled_frames
    b = next(batches(cfg, 1))
    b.label_mask[:, :, 0] = True
    b.frame_valid[:] = True
    cfg1 = replace(cfg, dataset=replace(cfg.dataset, max_labeled_frames=1))
    with pytest.raises(ValueError, match="max_labeled_frames"):
        make_trainer(cfg1, tmp_path).fit(iter([b]))
    # a token mask for a model without masking
    with pytest.raises(ValueError, match="enable_masking"):
        trainer.fit(batches(cfg, 1, token_masks=True))


def test_load_weights_from_flax_variables(tmp_path):
    """``load_weights`` takes JAX variables through the weight bridge: the
    state matches the bridge's, and the FPN + head forward (train-mode
    BatchNorm off) matches JAX's on the same features."""
    from rvt_tpu_torch.convert.from_flax import from_flax

    jcfg = tiny_cfg(preset_fn=j_preset)
    jm = JRVTDetector(cfg=replace(jcfg.model, compute_dtype="bfloat16"))
    x = jnp.zeros((1,) + model_input_hw_c(jcfg.model), jnp.float32)
    # a jitted init (eager init compiles op by op)
    variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), x, j_zero_states(jcfg.model.backbone, 1)))
    trainer = make_trainer(tiny_cfg(), tmp_path)
    trainer.load_weights(variables)
    ref = from_flax(variables)
    for n, t in trainer.model.state_dict().items():
        assert torch.equal(t, ref[n].to(t.dtype)), n
    rng = np.random.RandomState(0)
    bb = jcfg.model.backbone
    H, W = bb.in_res_hw
    feats = [rng.randn(2, H // bb.strides[s - 1], W // bb.strides[s - 1],
                       bb.stage_dims[s - 1]).astype(np.float32)
             for s in jcfg.model.fpn.in_stages]
    jpred = np.asarray(jax.jit(lambda v, f: jm.apply(
        v, f, train=False, method=JRVTDetector.forward_detect))(
            variables, [jnp.asarray(f) for f in feats]))
    trainer.model.eval()
    with torch.no_grad():
        tpred = trainer.model.forward_detect(
            [torch.from_numpy(f) for f in feats]).numpy()
    scale = max(np.abs(jpred).max(), 1.0)
    assert np.abs(tpred - jpred).max() < 0.05 * scale


def test_prefetch_iterator_order_and_error():
    cfg = tiny_cfg()
    items = list(batches(cfg, 7))
    out = list(PrefetchIterator(iter(items), prefetch_depth=3))
    assert len(out) == 7
    np.testing.assert_array_equal(out[0].ev_repr, items[0].ev_repr)
    np.testing.assert_array_equal(out[-1].ev_repr, items[-1].ev_repr)

    def failing():
        yield items[0]
        raise ValueError("boom")

    it = PrefetchIterator(failing())
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)
