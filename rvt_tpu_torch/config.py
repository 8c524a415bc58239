"""Typed configuration for the PyTorch port (a copy of ``rvt_tpu.config``).

The port imports nothing of ``rvt_tpu``, so it keeps its own copy of the
config dataclasses. They mirror the upstream RVT hydra config tree
(``config/``): the same *knobs* are exposed, but as frozen
dataclasses with a pure ``derive()`` step that mirrors the imperative
post-compose mutation in ``config/modifier.py:10-57`` (padded input
resolution, attention partition size, number of classes).

All shapes derived here are static so that every downstream function sees fixed
tensor shapes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Tuple


def _ceil_to_multiple(x: int, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """MaxViT window/grid attention knobs.

    Mirrors ``config/model/maxvit_yolox/default.yaml:25-37``.
    ``partition_size`` is derived from the dataset resolution.
    """

    partition_size: Tuple[int, int] = (0, 0)  # derived
    dim_head: int = 32
    attention_bias: bool = True
    mlp_activation: str = "gelu"
    mlp_gated: bool = False
    mlp_bias: bool = True
    mlp_ratio: int = 4
    drop_mlp: float = 0.0
    drop_path: float = 0.0
    ls_init_value: float = 1e-5
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class LstmConfig:
    """ConvLSTM knobs (``default.yaml:38-42``)."""

    dws_conv: bool = False
    dws_conv_only_hidden: bool = True
    dws_conv_kernel_size: int = 3
    drop_cell_update: float = 0.0


@dataclass(frozen=True)
class DownsampleConfig:
    """Patch-downsample knobs (``default.yaml:20-23``)."""

    overlap: bool = True
    norm_affine: bool = True
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class BackboneConfig:
    """4-stage recurrent MaxViT backbone (``maxvit_rnn.py:23-105``)."""

    input_channels: int = 20
    enable_masking: bool = False
    # Accept 4x4 space-to-depth-blocked input and fold the 7x7 stem kernel
    # into an equivalent 2x2 conv (see ops/s2d.py). The host input
    # pipeline must emit blocked tensors when enabled.
    stem_s2d: bool = False
    # Run the backbone on the hand-written kernels (ops/fused_*.py). As in
    # the JAX package, only configs with this set (and bf16 compute and the
    # shipped block variants, models/detector.py:fused_path_supported) take
    # the kernels; the others run the module path (models/layers.py), as
    # the JAX package runs its XLA modules.
    fused_kernels: bool = False
    partition_split_32: int = 2
    embed_dim: int = 64
    dim_multiplier: Tuple[int, ...] = (1, 2, 4, 8)
    num_blocks: Tuple[int, ...] = (1, 1, 1, 1)
    stem_patch_size: int = 4
    downsample: DownsampleConfig = field(default_factory=DownsampleConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    lstm: LstmConfig = field(default_factory=LstmConfig)
    in_res_hw: Tuple[int, int] = (0, 0)  # derived: padded model input H, W

    @property
    def num_stages(self) -> int:
        return len(self.num_blocks)

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * m for m in self.dim_multiplier)

    @property
    def strides(self) -> Tuple[int, ...]:
        strides = []
        s = 1
        for i in range(self.num_stages):
            s *= self.stem_patch_size if i == 0 else 2
            strides.append(s)
        return tuple(strides)


@dataclass(frozen=True)
class FPNConfig:
    """YOLO PAFPN (``yolo_pafpn.py:18-139``)."""

    depth: float = 0.67
    in_stages: Tuple[int, ...] = (2, 3, 4)
    depthwise: bool = False
    act: str = "silu"


@dataclass(frozen=True)
class HeadConfig:
    """YOLOX decoupled head (``yolo_head.py:21-152``)."""

    num_classes: int = 0  # derived from dataset
    depthwise: bool = False
    act: str = "silu"


@dataclass(frozen=True)
class PostprocessConfig:
    """Confidence filter + NMS (``config/model/rnndet.yaml``)."""

    confidence_threshold: float = 0.1
    nms_threshold: float = 0.45
    # TPU-native addition: NMS runs on-device with static shapes, so the
    # maximum number of detections kept per frame must be fixed.
    max_detections: int = 300
    # Max candidates entering NMS after the confidence filter (top-k by
    # score). <= 0 (default) NMS-es every anchor — exactly the reference
    # semantics (boxes.py:56-68), no truncation risk on dense scenes.
    # A positive value (e.g. 512, ~5x the realistic post-threshold count
    # on gen1/gen4) is an opt-in latency knob for serving; it is exact
    # only while fewer than k boxes pass the confidence threshold.
    pre_nms_topk: int = 0


@dataclass(frozen=True)
class ModelConfig:
    # "float32" | "bfloat16": computation dtype for convs/matmuls (master
    # params stay f32; norms, attention accumulation, LSTM state math and
    # box decode stay f32 regardless).
    compute_dtype: str = "float32"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    postprocess: PostprocessConfig = field(default_factory=PostprocessConfig)


# ---------------------------------------------------------------------------
# Dataset / training configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DatasetConfig:
    """Dataset geometry (``config/dataset/{gen1,gen4}.yaml``)."""

    name: str = "gen1"
    path: str = ""
    ev_repr_name: str = "stacked_histogram_dt=50_nbins=10"
    sequence_length: int = 21
    resolution_hw: Tuple[int, int] = (240, 304)
    downsample_by_factor_2: bool = False
    only_load_end_labels: bool = False
    # Sampling modes mirror data/utils/types.py:DatasetSamplingMode
    train_sampling: str = "mixed"  # 'random' | 'stream' | 'mixed'
    eval_sampling: str = "stream"
    # TPU-native static shape bounds (reference uses dynamic shapes):
    max_labels_per_frame: int = 48
    # Max labelled frames gathered per TBPTT window for the detect pass.
    max_labeled_frames: int = 8

    @property
    def num_classes(self) -> int:
        return {"gen1": 2, "gen4": 3}[self.name]

    @property
    def dataloading_hw(self) -> Tuple[int, int]:
        """Resolution of tensors coming from storage (after optional 2x ds).

        Mirrors ``data/utils/spatial.py:get_dataloading_hw``.
        """
        h, w = self.resolution_hw
        if self.downsample_by_factor_2:
            h, w = h // 2, w // 2
        return h, w


@dataclass(frozen=True)
class LRSchedulerConfig:
    """OneCycle schedule (``config/general.yaml`` training section)."""

    use: bool = True
    total_steps: int = 400_000
    pct_start: float = 0.005
    div_factor: float = 25.0  # init_lr = max_lr / div_factor
    final_div_factor: float = 10_000.0  # final_lr = max_lr / final_div_factor


@dataclass(frozen=True)
class TrainingConfig:
    precision: str = "bf16"  # TPU-native: bf16 instead of fp16
    max_steps: int = 400_000
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    gradient_clip_val: float = 1.0
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)


@dataclass(frozen=True)
class BatchSizeConfig:
    train: int = 8
    eval: int = 8


@dataclass(frozen=True)
class HardwareConfig:
    num_workers_train: int = 6
    num_workers_eval: int = 2
    # TPU mesh axes: data parallel size (devices). -1 = all local devices.
    dp_size: int = -1


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    batch_size: BatchSizeConfig = field(default_factory=BatchSizeConfig)
    hardware: HardwareConfig = field(default_factory=HardwareConfig)


# ---------------------------------------------------------------------------
# Derive step (mirror of config/modifier.py)
# ---------------------------------------------------------------------------


def derive(config: ExperimentConfig) -> ExperimentConfig:
    """Compute resolution-dependent model params.

    Mirrors ``dynamically_modify_train_config`` (``config/modifier.py:10-50``):
      * pad the dataloading resolution up to a multiple of
        ``32 * partition_split_32`` -> model input resolution,
      * attention partition size = input_hw / (32 * partition_split_32),
      * head num_classes from the dataset.
    """
    ds = config.dataset
    bb = config.model.backbone
    assert ds.name in ("gen1", "gen4"), ds.name
    assert bb.partition_split_32 in (1, 2, 4), bb.partition_split_32

    multiple_of = 32 * bb.partition_split_32
    hw = ds.dataloading_hw
    mdl_hw = (_ceil_to_multiple(hw[0], multiple_of), _ceil_to_multiple(hw[1], multiple_of))
    partition_size = tuple(x // multiple_of for x in mdl_hw)
    assert (mdl_hw[0] // 32) % partition_size[0] == 0
    assert (mdl_hw[1] // 32) % partition_size[1] == 0

    backbone = replace(
        bb,
        in_res_hw=mdl_hw,
        attention=replace(bb.attention, partition_size=partition_size),
    )
    head = replace(config.model.head, num_classes=ds.num_classes)
    model = replace(config.model, backbone=backbone, head=head)
    # A window of T frames can hold at most T labeled frames; clamp the
    # gather budget so short-window presets (gen4 T=5) produce a valid
    # static gather shape (training/step.py:gather_labeled_frames).
    if ds.max_labeled_frames > ds.sequence_length:
        ds = replace(ds, max_labeled_frames=ds.sequence_length)
        return replace(config, model=model, dataset=ds)
    return replace(config, model=model)


# ---------------------------------------------------------------------------
# Presets (mirror of config/experiment/{gen1,gen4}/{tiny,small,base}.yaml)
# ---------------------------------------------------------------------------

_SIZES = {
    # embed_dim, dim_head, fpn_depth
    "tiny": (32, 32, 0.33),
    "small": (48, 24, 0.33),
    "base": (64, 32, 0.67),
}


def preset(dataset: str = "gen1", size: str = "tiny", **dataset_overrides) -> ExperimentConfig:
    """Build a derived config matching a reference experiment preset.

    ``preset('gen1', 'base')`` corresponds to
    ``python train.py dataset=gen1 +experiment/gen1=base.yaml`` in the
    reference (see the upstream ``README.md``).
    """
    assert dataset in ("gen1", "gen4"), dataset
    assert size in _SIZES, size
    embed_dim, dim_head, fpn_depth = _SIZES[size]

    if dataset == "gen1":
        ds = DatasetConfig(
            name="gen1",
            sequence_length=21,
            resolution_hw=(240, 304),
            downsample_by_factor_2=False,
            # labels at 4 Hz on the 20 Hz repr grid -> at most
            # ceil(21/5) = 5 labelled frames per window (+1 margin);
            # sizing the static gather tightly cuts the per-window
            # head+NMS work by a quarter vs the default 8.
            max_labeled_frames=6,
        )
        partition_split_32 = 1  # experiment/gen1/default.yaml:42
        lr = 2e-4
        bs = BatchSizeConfig(train=8, eval=8)
        div_factor = 20.0
    else:
        ds = DatasetConfig(
            name="gen4",
            sequence_length=5,
            resolution_hw=(720, 1280),
            downsample_by_factor_2=True,
            # labels at 10 Hz on the 20 Hz repr grid -> at most
            # ceil(5/2) = 3 labelled frames per window (+1 margin).
            max_labeled_frames=4,
        )
        partition_split_32 = 2  # model default; gen4 keeps it
        lr = 3.46e-4
        bs = BatchSizeConfig(train=12, eval=12)
        div_factor = 20.0

    if dataset_overrides:
        valid = {f.name for f in dataclasses.fields(DatasetConfig)}
        unknown = set(dataset_overrides) - valid
        assert not unknown, f"unknown dataset overrides: {unknown}"
        ds = replace(ds, **dataset_overrides)

    cfg = ExperimentConfig(
        model=ModelConfig(
            backbone=BackboneConfig(
                embed_dim=embed_dim,
                partition_split_32=partition_split_32,
                attention=AttentionConfig(dim_head=dim_head),
            ),
            fpn=FPNConfig(depth=fpn_depth),
        ),
        dataset=ds,
        training=TrainingConfig(
            learning_rate=lr,
            lr_scheduler=LRSchedulerConfig(div_factor=div_factor),
        ),
        batch_size=bs,
    )
    return derive(cfg)
