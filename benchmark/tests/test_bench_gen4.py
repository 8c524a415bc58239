"""RVT-B at Prophesee 1 Mpx (gen4): the configuration file against the
port, the frozen counts against an independent count, and the port at
gen4's geometry at tiny widths against the plain reference on the CPU.

The tiny geometry keeps what gen4 changes: ``partition_split_32`` 2, so
several windows and grid cells at every stage (partitions of (2, 4) on
a 128 x 256 input, 2 x 2 of them at stage 4), a height that pads (120 to
128), T = 5 with K = 4 and three classes. ``tiny4_32`` runs the port's
float32 module path, held to float32 rounding as
``test_bench_reference.py`` holds gen1's; ``tiny4`` its bf16 kernels
(their plain twins on the CPU) at every stage, held to the limits of the
benchmark's own cells: the forward over an eval window and three train
steps (loss, leaf changes, states)."""
import json
import math
import time

import pytest
import torch

from benchmark.core.cell import run_cell
from benchmark.core.manifest import BENCH_DIR
from benchmark.core.port import port_config
from benchmark.counts import bounds, flops
from benchmark.reference import rvt
from benchmark.tests.tiny import tiny_copy

F32_GAP = 2e-3  # float32 against float32, as test_bench_reference.py
HW = [120, 256]
CELLS = {"window_eval": "rvtb_gen1.window_eval",
         "tbptt_train": "rvtb_gen4.tbptt_train"}


def gen4():
    cfg = json.loads((BENCH_DIR / "configs" / "rvtb_gen4.json").read_text())
    cfg["name"] = "rvtb_gen4"
    return cfg


def test_config_passes_the_port_and_derives_gen4():
    cfg = gen4()
    pc = port_config(cfg, stem_s2d=False)
    A = cfg["model"]
    assert list(pc.model.backbone.in_res_hw) == [384, 640]
    assert list(pc.model.backbone.attention.partition_size) == [6, 10]
    assert pc.model.backbone.partition_split_32 == 2
    assert pc.model.head.num_classes == 3
    assert bounds.anchors(A) == 5040

    from rvt_tpu_torch.training.step import head_grid
    grid, stride = head_grid(pc)
    ref_grid, ref_stride = rvt.anchor_grid(A, "cpu")
    assert len(stride) == 5040
    assert torch.equal(torch.from_numpy(grid).float(), ref_grid)
    assert torch.equal(torch.from_numpy(stride).float(), ref_stride)


def test_config_drift_is_refused():
    cfg = gen4()
    cfg["model"]["partition_size"] = [12, 20]
    with pytest.raises(ValueError, match="partition_size"):
        port_config(cfg, stem_s2d=False)


def _counted(A):
    """FLOPs of one frame through the reference, counted by PyTorch's
    flop counter on meta tensors: (every product, the backbone's matrix
    products without its downsample convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    P = {n: torch.empty(s, device="meta") for n, s, _ in rvt.specs(A)}
    H, W = A["in_res_hw"]
    ev = torch.empty(1, 1, H, W, A["input_channels"], device="meta")
    states = rvt.zero_states(A, 1, "meta")
    with FlopCounterMode(display=False) as fc:
        feats, _ = rvt.backbone_window(P, A, ev, states)
        bb = fc.get_total_flops()
        counts = fc.get_flop_counts()["Global"]
        rvt.detect([f[0] for f in feats], P, A,
                   rvt.BatchNorms(P, train=False))
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    return fc.get_total_flops(), bb - conv


def test_flops_and_bounds_against_an_independent_count():
    """The frozen count at 384 x 640, (6, 10) partitions and 3 classes is
    the reference's own products, counted by PyTorch: 31.26 GFLOP a
    frame; the train step's bound (every stage limited by its operations
    at gen4) is three times the backbone's matrix products at the peak."""
    A = gen4()["model"]
    total, matmul = _counted(A)
    assert flops.per_frame(A)["total"] == total == 31_259_197_440
    assert flops.train_step(A, 12, 5, 4) / 1e12 == pytest.approx(5.2435,
                                                                 abs=5e-5)
    least = 3 * matmul * 12 * 5 / flops.PEAK_BF16_FLOPS
    assert bounds.train_step(A, 12, 5) == pytest.approx(least, rel=1e-12)
    assert bounds.train_step(A, 12, 5) * 1e3 == pytest.approx(3.0924,
                                                              abs=1e-4)


def tiny_model():
    from rvt_tpu_torch.config import preset

    pc = preset("gen4", "tiny", resolution_hw=tuple(HW),
                downsample_by_factor_2=False)
    bb = pc.model.backbone
    return {"embed_dim": bb.embed_dim, "dim_head": bb.attention.dim_head,
            "fpn_depth": pc.model.fpn.depth, "resolution_hw": HW,
            "in_res_hw": list(bb.in_res_hw),
            "partition_size": list(bb.attention.partition_size),
            "num_classes": pc.model.head.num_classes,
            "sequence_length": pc.dataset.sequence_length,
            "max_labeled_frames": pc.dataset.max_labeled_frames}


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """The tiny copy of the benchmark with gen4's tiny cells."""
    tmp = tmp_path_factory.mktemp("bench")
    m = tiny_copy(tmp)
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    base = gen4()
    for name, program in (("tiny4", base["program"]),
                          ("tiny4_32", {"compute_dtype": "float32",
                                        "fused_kernels": False})):
        cfg = json.loads(json.dumps(base))
        cfg["preset"] = ["gen4", "tiny"]
        cfg["dataset_overrides"] = {"resolution_hw": HW,
                                    "downsample_by_factor_2": False}
        cfg["program"] = program
        cfg["model"].update(tiny_model())
        (m.dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "tests"})
        for kind, real in CELLS.items():
            wl = json.loads((BENCH_DIR / "workloads" / f"{real}.json"
                             ).read_text())
            wl["config"] = name
            wl["traffic_params"].update(
                {"lanes": 2, "pool_windows": 2, "pool_batches": 3,
                 "box_side": [5, 30]})
            wl["profile"] = {"after_s": 0.0, "calls": 2}
            cell = f"{name}.{kind}"
            (m.dir / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
            spec["workloads"].append({"name": cell, "config": name,
                                      "traffic": kind, "chips": 1,
                                      "why": "tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return type(m)(root=tmp, bench_dir=m.dir)


def test_tiny_geometry_has_gen4_partitions_on_the_kernels():
    from dataclasses import replace

    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.models.detector import stage_geometries, stage_routes

    pc = preset("gen4", "tiny", resolution_hw=tuple(HW),
                downsample_by_factor_2=False)
    model = replace(pc.model, compute_dtype="bfloat16",
                    backbone=replace(pc.model.backbone, fused_kernels=True))
    part = model.backbone.attention.partition_size
    assert model.backbone.in_res_hw == (128, 256) and part == (2, 4)
    for H, W, _ in stage_geometries(model):
        assert H // part[0] >= 2 and W // part[1] >= 2  # several, each way
    for path in ("serve", "train"):
        assert stage_routes(model, path) == ["kernels"] * 4


def _run(manifest, cell, seed):
    return run_cell(cell, seed, 0.3, False, t_start=time.perf_counter(),
                    device="cpu", manifest=manifest, log=lambda *a: None)


@pytest.mark.parametrize("kind", list(CELLS))
def test_reference_matches_port_f32_at_gen4_geometry(manifest, kind):
    r = _run(manifest, f"tiny4_32.{kind}", 2 ** 31 + 9)
    assert r["attempted"] > 0 and r["failed"] == 0
    for name, c in r["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] <= F32_GAP, (name, c)


@pytest.mark.parametrize("kind", list(CELLS))
def test_kernel_twins_pass_the_cells_limits_at_gen4_geometry(manifest, kind):
    r = _run(manifest, f"tiny4.{kind}", 2 ** 31 + 11)
    assert r["correct"], r["checks"]
