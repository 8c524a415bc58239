"""The port runs a config on its kernels only where the JAX package runs
it on its own (``fused_path_supported``: the gate of
``rvt_tpu/models/detector.py:_fused_scan_supported`` and of
``RVTStage._whole_stage_fused``); elsewhere the JAX package takes its XLA
module path (erf-gelu, LayerScale not folded), which the port has not
ported, and every entry point of the port raises ``NotImplementedError``
before any stage runs. gen1 tiny at (64, 80) on the CPU."""
from dataclasses import replace

import pytest
import torch

import rvt_tpu_torch.models.detector as det
from rvt_tpu.config import preset as j_preset
from rvt_tpu.models import RVTDetector as JRVTDetector
from rvt_tpu.models.detector import _fused_scan_supported
from rvt_tpu_torch.config import preset
from rvt_tpu_torch.inference import make_raw_inference_step
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import make_eval_step, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

T, B = 1, 1


def _run_entry(name, model, cfg):
    """Call one entry point of the port once on a tiny input."""
    bb = cfg.model.backbone
    H, W = bb.in_res_hw
    states = zero_states(bb, B, device="cpu")
    ev = torch.randint(0, 4, (T, B, H, W, 20)).float()
    fv = torch.ones(B, T, dtype=torch.bool)
    first = torch.ones(B, dtype=torch.bool)
    if name == "fused_scan_backbone":
        det.fused_scan_backbone(model, ev, states,
                                det.backbone_kernel_params(model))
    elif name == "fused_train_scan_backbone":
        det.fused_train_scan_backbone(model, ev, states)
    elif name == "forward":
        model(ev[0], states, det.backbone_kernel_params(model))
    elif name == "make_eval_step":
        make_eval_step(model, cfg)(states, ev.transpose(0, 1), fv, first)
    elif name == "make_train_step":
        M = cfg.dataset.max_labels_per_frame
        labels = torch.zeros(B, T, M, 7)
        labels[..., 0, 1:5] = torch.tensor([8.0, 8.0, 16.0, 16.0])
        mask = torch.zeros(B, T, M, dtype=torch.bool)
        mask[..., 0] = True
        step = make_train_step(model, cfg, make_optimizer(
            model.parameters(), cfg.training))
        step(states, ev.transpose(0, 1), labels, mask, fv, first)
    else:
        events = [torch.randint(0, 60, (B, 16), dtype=torch.int32)
                  for _ in range(4)]
        events[3] = torch.sort(events[3], dim=1).values
        make_raw_inference_step(model, cfg)(
            states, *events, torch.full((B,), 16, dtype=torch.int32), first)


ENTRIES = ("fused_scan_backbone", "fused_train_scan_backbone", "forward",
           "make_eval_step", "make_train_step", "make_raw_inference_step")


@pytest.fixture
def stage_calls(monkeypatch):
    """Counts the stage functions the backbones run (the kernels' only
    way in)."""
    calls = []
    for fn in ("fused_stage_scan", "split_stage_scan_train",
               "fused_stage_step_train"):
        orig = getattr(det, fn)
        monkeypatch.setattr(det, fn, lambda *a, _o=orig, _n=fn, **k: (
            calls.append(_n), _o(*a, **k))[1])
    return calls


def _cfg(fused=True):
    cfg = preset("gen1", "tiny", resolution_hw=(64, 80), sequence_length=T,
                 max_labels_per_frame=2, max_labeled_frames=1)
    if fused:
        cfg = replace(cfg, model=replace(
            cfg.model, compute_dtype="bfloat16",
            backbone=replace(cfg.model.backbone, fused_kernels=True)))
    return cfg


@pytest.mark.parametrize("entry", ENTRIES)
def test_shipped_preset_raises(entry, stage_calls):
    """``preset("gen1", "tiny")`` as it stands (fused_kernels False, f32
    compute): JAX's make_train_step runs its module path on it."""
    cfg = _cfg(fused=False)
    assert not det.fused_path_supported(cfg.model)
    model = det.init_detector(cfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match="XLA module path"):
        _run_entry(entry, model, cfg)
    assert stage_calls == []


@pytest.mark.parametrize("entry", ENTRIES)
def test_fused_config_runs(entry, stage_calls):
    """The same preset with fused_kernels and bf16 compute: every entry
    point runs its stages."""
    cfg = _cfg()
    assert det.fused_path_supported(cfg.model)
    _run_entry(entry, det.init_detector(cfg.model, device="cpu"), cfg)
    assert len(stage_calls) == 4


def _with(m, field, value):
    """ModelConfig ``m`` (either package's) with one gate field set."""
    bb = m.backbone
    if field == "compute_dtype":
        return replace(m, compute_dtype=value)
    if field in ("fused_kernels", "num_blocks"):
        return replace(m, backbone=replace(bb, **{field: value}))
    if field in ("dws_conv", "drop_cell_update"):
        return replace(m, backbone=replace(bb, lstm=replace(
            bb.lstm, **{field: value})))
    return replace(m, backbone=replace(bb, attention=replace(
        bb.attention, **{field: value})))


def _j_fused():
    m = j_preset("gen1", "tiny", resolution_hw=(64, 80)).model
    return replace(m, compute_dtype="bfloat16",
                   backbone=replace(m.backbone, fused_kernels=True))


VARIANTS = [("fused_kernels", False), ("compute_dtype", "float32"),
            ("num_blocks", (2, 1, 1, 1)), ("mlp_gated", True),
            ("attention_bias", False), ("mlp_bias", False),
            ("ls_init_value", 0.0), ("drop_path", 0.1), ("drop_mlp", 0.1),
            ("mlp_activation", "relu"), ("dws_conv", True),
            ("drop_cell_update", 0.1)]


@pytest.mark.parametrize("field,value", VARIANTS,
                         ids=[f for f, _ in VARIANTS])
def test_each_gate_field(field, value, stage_calls):
    """One field off the shipped variant: the JAX gate and the port's
    agree, and the port raises (the containers already refuse the block
    and LSTM variants they do not hold; the rest reach the gate)."""
    mcfg = _with(_cfg().model, field, value)
    assert _fused_scan_supported(JRVTDetector(
        cfg=_with(_j_fused(), field, value))) is False
    assert det.fused_path_supported(mcfg) is False
    cfg = replace(_cfg(), model=mcfg)
    with pytest.raises(NotImplementedError):
        model = det.init_detector(mcfg, device="cpu")
        _run_entry("make_train_step", model, cfg)
    assert stage_calls == []


def test_shipped_gate_agrees_with_jax():
    """The fused config passes both gates; the shipped preset neither."""
    shipped = j_preset("gen1", "tiny", resolution_hw=(64, 80)).model
    for fused, jm in ((True, _j_fused()), (False, shipped)):
        assert _fused_scan_supported(JRVTDetector(cfg=jm)) is fused
        assert det.fused_path_supported(_cfg(fused).model) is fused


PRESETS = [(d, s) for d in ("gen1", "gen4") for s in ("tiny", "small",
                                                      "base")]


@pytest.mark.parametrize("dataset,size", PRESETS)
def test_preset_stage_envelopes_agree_with_jax(dataset, size):
    """Every stage of the six presets, and of each at a partition the JAX
    kernels cannot split ((8, 5): an odd minor), is in or out of the port's
    per-stage envelopes exactly where it is in or out of JAX's
    ``pair_fusion_mode`` (serving) and ``train_stage_mode`` (training
    over the window and per step)."""
    from rvt_tpu.ops.fused_attention import pair_fusion_mode
    from rvt_tpu.ops.fused_train import train_stage_mode

    m = preset(dataset, size).model
    for part in (tuple(m.backbone.attention.partition_size), (8, 5)):
        mp = _with(m, "partition_size", part)
        serve = det.stage_path_supported(mp, "serve")
        train = det.stage_path_supported(mp, "train")
        per_step = det.stage_path_supported(mp, "train_per_step")
        for i, (H, W, C) in enumerate(det.stage_geometries(mp)):
            assert serve[i] == (pair_fusion_mode(H, W, C, part)
                                is not None), (H, W, C, part)
            assert train[i] == (train_stage_mode(H, W, C, part, scan=True)
                                is not None), (H, W, C, part)
            assert per_step[i] == (train_stage_mode(H, W, C, part,
                                                    scan=False)
                                   is not None), (H, W, C, part)


def _off_envelope_cfg():
    """gen1 tiny at 256 x 320 with partition (8, 5): its 64 x 80 x 32
    stage 1 fits neither the partitioned geometry (an odd minor) nor the
    masked-dense one (> 1024 tokens), so JAX serves and trains it on its
    XLA modules; the structural gate still passes."""
    cfg = _cfg()
    cfg = replace(cfg, model=_with(cfg.model, "partition_size", (8, 5)))
    bb = replace(cfg.model.backbone, in_res_hw=(256, 320))
    return replace(cfg, model=replace(cfg.model, backbone=bb))


@pytest.mark.parametrize("entry", ENTRIES)
def test_off_envelope_geometry_raises(entry, stage_calls):
    """A geometry override that JAX routes to its XLA modules: each entry
    point raises before any stage runs, naming the stage."""
    from rvt_tpu.ops.fused_attention import pair_fusion_mode
    from rvt_tpu.ops.fused_train import train_stage_mode

    cfg = _off_envelope_cfg()
    assert det.fused_path_supported(cfg.model)
    assert pair_fusion_mode(64, 80, 32, (8, 5)) is None
    assert train_stage_mode(64, 80, 32, (8, 5), scan=True) is None
    model = det.init_detector(cfg.model, device="cpu")
    with pytest.raises(NotImplementedError, match="64x80x32"):
        _run_entry(entry, model, cfg)
    assert stage_calls == []
