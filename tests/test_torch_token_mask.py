"""Token-masked training on the port (``enable_masking``: stage 1's
downsample LN and the mask-token replacement in torch, its kernels with
``ds_ln=False``), the kernels' plain versions on the CPU, against the JAX
package's masked fused train path (interpret mode): two carried gen1-tiny
train steps with a seeded token mask on each window, held as
``test_torch_train_step.py`` holds the unmasked steps; the backbone under
``test_torch_train_backbone.py``'s linear loss, every leaf (the mask
token's included) as that file holds it; and ``pad_token_mask``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvt_tpu.training.step import pad_token_mask as j_pad_token_mask
from rvt_tpu_torch.training.step import pad_token_mask
from tests import test_torch_train_backbone as tb
from tests import test_torch_train_step as ts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the suite runs in
    parallel workers, where per-process thread pools oversubscribe the
    cores and every small op waits on them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

MASK_TOKEN = "backbone.stages.0.mask_token"


@pytest.fixture(scope="module")
def runs():
    return ts.train_runs(masked=True)


def test_masked_train_step_losses_match_jax(runs):
    """The loss, iou_loss, conf_loss and num_fg within LOSS_RTOL as the
    unmasked steps; cls_loss within LOSS_RTOL of the loss. This model
    (the mask token draws from the init generator, so every later weight
    differs from the unmasked test's) puts one anchor in the foreground,
    whose class logits the head's amplification of bf16 feature noise
    moves by a few percent: port and JAX differ in cls_loss by 2.5 and 3.6
    % (one intra-op thread), and by 3.9 % on the same weights without any
    token mask, so not through the masking."""
    ts.check_losses(runs, cls_of_loss=True)


def test_masked_train_step_final_states_match_jax(runs):
    ts.check_final_states(runs)


def test_masked_train_step_grads_match_jax(runs):
    ts.check_grads(runs)
    jg, tg, _ = runs["grads"]
    assert bool(jg[MASK_TOKEN].any()) and bool(tg[MASK_TOKEN].any())


def test_masked_train_step_bn_buffers_and_params_match_jax(runs):
    ts.check_bn_buffers_and_params(runs)


@pytest.fixture(scope="module")
def backbone():
    return tb.backbone_case(masked=True)


def test_masked_backbone_forward_matches_jax(backbone):
    tb.check_forward(backbone)


def test_masked_backbone_grads_match_jax(backbone):
    """Every leaf at the backbone's GRAD_TOL; the mask token's gradient
    flows (nonzero) and agrees (tests/test_fused_train.py:240-246)."""
    errs = tb.check_grads(backbone)
    assert MASK_TOKEN in errs
    assert bool(backbone[3][MASK_TOKEN].any())


@pytest.mark.parametrize("hw", [(16, 20), (16, 24), (15, 19)])
def test_pad_token_mask_matches_jax(hw):
    tm = np.random.RandomState(2).rand(2, 3, *hw) < 0.3
    got = pad_token_mask(torch.from_numpy(tm), (64, 96), 4)
    ref = np.asarray(j_pad_token_mask(jnp.asarray(tm), (64, 96), 4))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
