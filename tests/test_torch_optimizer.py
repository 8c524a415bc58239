"""The port's OneCycle + clip + AdamW (rvt_tpu_torch.training.optimizer)
against the JAX package's ``make_optimizer`` (optax) over 6 steps with
total_steps = 8: the warm-up ends after step 4, and step 3's gradients are
large enough to be clipped."""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from rvt_tpu.config import TrainingConfig as JTrainingConfig
from rvt_tpu.config import LRSchedulerConfig as JLRSchedulerConfig
from rvt_tpu.training.optimizer import make_optimizer as j_make_optimizer
from rvt_tpu.training.optimizer import onecycle_schedule as j_schedule
from rvt_tpu_torch.config import LRSchedulerConfig, TrainingConfig
from rvt_tpu_torch.training.optimizer import make_optimizer, onecycle_schedule

SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
STEPS = 6


def _cfgs(weight_decay):
    kw = dict(learning_rate=1e-2, weight_decay=weight_decay,
              gradient_clip_val=1.0)
    sk = dict(total_steps=8, pct_start=0.5, div_factor=20.0,
              final_div_factor=100.0)
    return (JTrainingConfig(lr_scheduler=JLRSchedulerConfig(**sk), **kw),
            TrainingConfig(lr_scheduler=LRSchedulerConfig(**sk), **kw))


def test_schedule_matches_optax():
    jc, tc = _cfgs(0.0)
    js, ts = j_schedule(jc), onecycle_schedule(tc)
    for count in range(10):
        assert ts(count) == float(js(count)), count


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_six_steps_match_optax(weight_decay):
    jc, tc = _cfgs(weight_decay)
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jopt = j_make_optimizer(jc)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = make_optimizer(tparams.values(), tc)
    clipped = 0
    for step in range(STEPS):
        scale = 1.0 if step == 2 else 0.02  # step 3: ||g|| ~ 7 > 1
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                                  jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        gnorm = float(topt.step())
        ref_norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                     for g in grads.values())))
        np.testing.assert_allclose(gnorm, ref_norm, rtol=1e-6)
        clipped += gnorm >= 1.0
        for k, p in tparams.items():
            # f32 both; the global norm is summed in another order
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8,
                                       err_msg=f"step {step + 1} {k}")
            assert torch.equal(p.grad, torch.from_numpy(grads[k]))
    assert clipped == 1 and topt.count == STEPS


def test_device_scalars_clip_and_static_grads():
    """The step as a captured graph runs it: ``load_scalars`` puts this
    step's bias corrections and -lr (f32, optax's schedule bit for bit)
    into a device tensor, ``update`` reads nothing back (the clip is a
    device-side select), and the gradients keep their tensors
    (``zero_grad`` zeroes in place). Over 6 steps across the warm-up's
    end, one of them clipped, the parameters follow ``step``'s exactly;
    gradients a caller dropped come back as the same tensors."""
    from tests.test_torch_graphs import forbid_host_reads

    jc, tc = _cfgs(0.05)
    js = j_schedule(jc)
    rng = np.random.RandomState(1)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    a = [torch.nn.Parameter(torch.from_numpy(v.copy()))
         for v in init.values()]
    b = [torch.nn.Parameter(torch.from_numpy(v.copy()))
         for v in init.values()]
    oa, ob = make_optimizer(a, tc), make_optimizer(b, tc)
    oa.zero_grad()
    static = [p.grad for p in a]
    clipped = 0
    for step in range(STEPS):
        scale = 1.0 if step == 2 else 0.02
        grads = [torch.from_numpy((rng.randn(*s) * scale).astype(
            np.float32)) for s in SHAPES.values()]
        if step == 3:  # a caller dropping the gradients
            for p in a:
                p.grad = None
        oa.zero_grad()
        assert all(p.grad is g and not g.any() for p, g in zip(a, static))
        for g, src, p in zip(static, grads, b):
            g.add_(src)
            p.grad = src
        oa.load_scalars()
        n = step + 1
        want = np.array([np.float32(1) - np.float32(0.9) ** np.float32(n),
                         np.float32(1) - np.float32(0.999) ** np.float32(n),
                         -np.float32(js(step))], np.float32)
        np.testing.assert_array_equal(oa.scalars.numpy(), want)
        with forbid_host_reads():
            norm = oa.update()
        clipped += float(norm) >= tc.gradient_clip_val
        assert torch.equal(norm, ob.step())
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb), f"step {n}"
    assert clipped == 1 and oa.count == ob.count == STEPS
