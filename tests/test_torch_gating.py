"""How the port routes a config, as the JAX package does: the window
scans run on the kernels only for configs ``fused_path_supported``
passes (the gate of ``rvt_tpu/models/detector.py:_fused_scan_supported``)
and, per stage, at geometries inside the JAX kernels' envelopes
(``stage_routes``); every other config runs the module path
(``models/layers.py``), serving a ``fused_kernels`` config in bf16 with
the blocks on the kernels where the JAX modules put them, and a stage
outside the envelope runs the module pair (and K4 where JAX serves its
kernel). Every entry point runs each case. gen1 tiny at (64, 80) on the
CPU; the test names of the cases that raised before the module path was
ported are kept."""
from dataclasses import replace

import pytest
import torch

import rvt_tpu_torch.models.detector as det
import rvt_tpu_torch.models.layers as tl
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
    params = (det.backbone_kernel_params(model)
              if det.fused_path_supported(model.cfg) else None)
    if name == "fused_scan_backbone":
        det.fused_scan_backbone(model, ev, states, params)
    elif name == "fused_train_scan_backbone":
        det.fused_train_scan_backbone(model, ev, states)
    elif name == "forward":
        with torch.no_grad():
            model(ev[0], states, params)
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


class _Calls(list):
    """The kernel calls, and ``pairs``: the module attention blocks run."""
    pairs: list


STAGE_FNS = ("fused_stage_scan", "split_stage_scan_train",
             "fused_stage_step_train")


@pytest.fixture
def stage_calls(monkeypatch):
    """Counts the calls into the kernels: the stage functions the
    backbones run, K4 at T = 1 on the off-envelope stages
    ("fused_conv_lstm"), and the modules' own kernel routes
    ("layers.fused_attention_pair", "layers.fused_conv_lstm"); and, under
    "pairs", the module attention pairs that ran (outside the list)."""
    calls = _Calls()
    for mod, fn, name in ([(det, f, f) for f in STAGE_FNS]
                          + [(det, "fused_conv_lstm", "fused_conv_lstm")]
                          + [(tl, f, "layers." + f) for f in (
                              "fused_attention_pair", "fused_conv_lstm")]):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    pairs = []
    orig_pair = tl.PartitionAttention.forward
    monkeypatch.setattr(tl.PartitionAttention, "forward",
                        lambda self, *a, **k: (pairs.append(self.window),
                                               orig_pair(self, *a, **k))[1])
    calls.pairs = pairs
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
    compute), which JAX's make_train_step runs on its module path: every
    entry point of the port runs it on the module path, no kernel
    called (the name is from when the port raised here)."""
    cfg = _cfg(fused=False)
    assert not det.fused_path_supported(cfg.model)
    for path in ("serve", "train", "train_per_step"):
        assert det.stage_routes(cfg.model, path) == ["modules"] * 4
    model = det.init_detector(cfg.model, device="cpu")
    _run_entry(entry, model, cfg)
    assert stage_calls == []
    assert len(stage_calls.pairs) >= 8  # window and grid, 4 stages


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
    agree, and the eval entry runs on the module path, the blocks on the
    kernels where the JAX modules put them when serving a
    ``fused_kernels`` config in bf16 (a pair of the shipped variant at a
    geometry in the envelope on K1-K3, a 1x1 cell without dropout on K4).
    A dropout rate above 0 refuses the train step, as JAX's train step
    raises without a 'dropout' rng."""
    mcfg = _with(_cfg().model, field, value)
    assert _fused_scan_supported(JRVTDetector(
        cfg=_with(_j_fused(), field, value))) is False
    assert det.fused_path_supported(mcfg) is False
    assert det.stage_routes(mcfg) == ["modules"] * 4
    cfg = replace(_cfg(), model=mcfg)
    model = det.init_detector(mcfg, device="cpu")
    _run_entry("make_eval_step", model, cfg)
    kernels = det.kernels_serve(mcfg, True)
    pairs = sum(mcfg.backbone.num_blocks) * T * (
        kernels and tl.attention_variant_shipped(mcfg.backbone.attention))
    cells = 4 * T * (kernels and tl.lstm_variant_shipped(mcfg.backbone.lstm))
    assert stage_calls.count("layers.fused_attention_pair") == pairs
    assert stage_calls.count("layers.fused_conv_lstm") == cells
    assert len(stage_calls) == pairs + cells
    if field in ("drop_path", "drop_mlp", "drop_cell_update"):
        with pytest.raises(NotImplementedError, match=field):
            _run_entry("make_train_step", model, cfg)


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
    """A geometry override that JAX routes to its XLA modules at stages 1
    and 2: there the port runs the module pair, then on the serving
    paths the cell on K4 at T = 1 (``rvt_tpu/models/detector.py:345-370``)
    and on the training paths the module cell under checkpoint
    (``:487-520``); stages 3 and 4 run the kernels (the name is from when
    the port raised here)."""
    from rvt_tpu.ops.fused_attention import pair_fusion_mode
    from rvt_tpu.ops.fused_train import train_stage_mode

    cfg = _off_envelope_cfg()
    assert det.fused_path_supported(cfg.model)
    geo = det.stage_geometries(cfg.model)
    assert [pair_fusion_mode(*g, (8, 5)) is None for g in geo] == [
        True, True, False, False]
    assert [train_stage_mode(*g, (8, 5), scan=True) is None
            for g in geo] == [True, True, False, False]
    train = entry in ("fused_train_scan_backbone", "make_train_step")
    assert det.stage_routes(cfg.model, "train" if train else "serve") == (
        ["modules" if train else "modules+K4"] * 2 + ["kernels"] * 2)
    model = det.init_detector(cfg.model, device="cpu")
    _run_entry(entry, model, cfg)
    if train:
        assert stage_calls == ["split_stage_scan_train"] * 2
    else:
        assert sorted(stage_calls) == sorted(
            ["fused_conv_lstm"] * 2 * T + ["fused_stage_scan"] * 2)
    # window and grid of the module pair at stages 1 and 2 (the train
    # step's backward recomputes them under checkpoint)
    assert len(stage_calls.pairs) == 2 * 2 * T * (
        2 if entry == "make_train_step" else 1)
