"""The port's weight bridge, its import hygiene (no JAX, nothing of
rvt_tpu) and its device rule (entry points raise without a card unless
the caller asks for the CPU)."""
import ast
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from rvt_tpu.config import preset
from rvt_tpu.convert.torch_ckpt import convert_state_dict
from rvt_tpu.models import init_detector
from rvt_tpu_torch.config import preset as t_preset
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import RVTDetector
from rvt_tpu_torch.models.detector import init_detector as t_init_detector
from rvt_tpu_torch.training.step import init_train_state

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rvt_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rvt_tpu")


def _cfg(preset_fn):
    cfg = preset_fn("gen1", "tiny", resolution_hw=(64, 80))
    return replace(cfg, model=replace(cfg.model, backbone=replace(
        cfg.model.backbone, stem_s2d=True, enable_masking=True)))


@pytest.fixture(scope="module")
def variables():
    _, v = init_detector(_cfg(preset).model, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


def test_bridge_assigns_every_parameter_once(variables):
    """from_flax covers the port's whole state_dict with the right shapes,
    and the JAX package's torch->flax converter inverts it exactly."""
    sd = from_flax(variables)
    model = RVTDetector(_cfg(t_preset).model)
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    model.load_state_dict(sd, strict=True)

    back = convert_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_ref = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_back) == len(flat_ref)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))


@pytest.mark.parametrize("stage,s2d", [(0, True), (0, False), (1, False)],
                         ids=["stem_s2d", "stem", "stage2"])
def test_downsample_conv_matches_jax(variables, stage, s2d):
    """The batched downsample conv of the serving scan (bf16 operands, the
    7x7 stem folded for s2d input) against the JAX package's."""
    import jax.numpy as jnp

    from rvt_tpu.models.detector import downsample_conv_apply as j_conv
    from rvt_tpu_torch.models.detector import downsample_conv_apply as t_conv
    from rvt_tpu_torch.ops.s2d import host_space_to_depth

    cfg = replace(_cfg(preset).model.backbone, stem_s2d=s2d)
    model = RVTDetector(_cfg(t_preset).model)
    model.load_state_dict(from_flax(variables), strict=True)
    rng = np.random.RandomState(stage)
    H, W = cfg.in_res_hw
    if stage == 0:
        x = rng.randint(0, 8, (2, H, W, 20)).astype(np.uint8)
        if s2d:
            x = host_space_to_depth(x, (H, W))
    else:
        x = rng.randn(2, H // 4, W // 4, cfg.stage_dims[0]).astype(np.float32)
    sp = variables["params"]["backbone"][f"stage{stage + 1}"]
    ref = j_conv(jnp.asarray(x), sp, cfg, stage == 0)
    tcfg = replace(_cfg(t_preset).model.backbone, stem_s2d=s2d)
    with torch.no_grad():  # as the serving steps call it
        got = t_conv(torch.from_numpy(x), model.backbone.stages[stage], tcfg,
                     stage == 0)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-2,
                               atol=1e-2)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_sources_import_nothing_of_jax():
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_port_modules_load_with_jax_blocked():
    """Import every module of the port and chip_smoke.py in a fresh
    interpreter where importing jax, flax, optax or rvt_tpu fails."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules] + ["chip_smoke"]
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        f"       m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_preset("gen1", "tiny", resolution_hw=(64, 80))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_init_detector(cfg.model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zero_states(cfg.model.backbone, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg)
    state = init_train_state(cfg, device="cpu")
    assert state.optimizer.count == 0
    assert all(p.device.type == "cpu" for p in state.model.parameters())
    model = t_init_detector(cfg.model, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    states = zero_states(cfg.model.backbone, 2, device="cpu")
    assert states[0][0].shape == (2, 16, 24, 32)
