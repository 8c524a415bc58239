"""The check catches a broken timed path. A tiny cell of each kind runs
on the CPU without the look for a card, the program on its float32
module path, held to the limits of the benchmark's own cell of that
kind: sound, ``correct`` is true; with each fault that the kind can have
planted in the program's step (a step that returns its state unchanged;
half of the lanes left out, the loss's mean taken over the rest; an
answer altered where it is produced), ``correct`` is false. One chip, so
no exchange between chips can be left out.

A fault is planted by wrapping the step that the port's factory
(``make_eval_step``, ``make_raw_inference_step``, ``make_train_step``)
returns: the drivers build their step through it and know nothing of
the fault."""
import json
import time

import pytest
import torch

from benchmark.core.cell import run_cell
from benchmark.core.manifest import BENCH_DIR
from benchmark.tests.tiny import CELL, KINDS, tiny_copy

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    m = tiny_copy(tmp)
    for kind in KINDS:
        real = json.loads((BENCH_DIR / "workloads" / f"{CELL[kind]}.json"
                           ).read_text())
        path = m.dir / "workloads" / f"tiny32.{kind}.json"
        wl = json.loads(path.read_text())
        wl["limits"] = real["limits"]
        path.write_text(json.dumps(wl))
    return m


def halved(states):
    """The lanes' second half zeroed: left out of the step."""
    def cut(x):
        h = x.shape[0] // 2
        return torch.cat([x[:h], torch.zeros_like(x[h:])])
    return tuple(tuple(cut(x) for x in hc) for hc in states)


def eval_fault(fault, step):
    def broken(states, x, fv, first):
        out = step(states, x, fv, first)
        if fault == "state_unchanged":
            return out._replace(states=states)
        if fault == "half_batch":
            preds = out.preds.clone()
            preds[preds.shape[0] // 2:] = 0
            return out._replace(states=halved(out.states), preds=preds)
        valid = out.det_valid.clone()
        valid[0, 0, 0] = ~valid[0, 0, 0]
        return out._replace(det_valid=valid)
    return broken


def raw_fault(fault, step):
    def broken(states, *events_and_first):
        new, dets, valid = step(states, *events_and_first)
        if fault == "state_unchanged":
            return states, dets, valid
        if fault == "half_batch":
            return halved(new), dets, valid
        valid = valid.clone()
        valid[0, 0] = ~valid[0, 0]
        return new, dets, valid
    return broken


def train_fault(fault, step, model):
    def broken(states, ev, labels, mask, fv, first):
        if fault == "half_batch":
            h = ev.shape[0] // 2
            new, m = step(tuple((a[:h], c[:h]) for a, c in states), ev[:h],
                          labels[:h], mask[:h], fv[:h], first[:h])
            return tuple((torch.cat([a, b[h:]]), torch.cat([c, d[h:]]))
                         for (a, c), (b, d) in zip(new, states)), m
        before = [p.detach().clone() for p in model.parameters()]
        new, m = step(states, ev, labels, mask, fv, first)
        if fault == "state_unchanged":
            with torch.no_grad():
                for p, q in zip(model.parameters(), before):
                    p.copy_(q)
            return new, m
        return new, dict(m, loss=m["loss"] * 1.5)
    return broken


def plant(monkeypatch, kind, fault):
    import rvt_tpu_torch.inference as inference
    import rvt_tpu_torch.training.step as steps

    if kind == "window_eval":
        make = steps.make_eval_step
        monkeypatch.setattr(steps, "make_eval_step", lambda *a, **k:
                            eval_fault(fault, make(*a, **k)))
    elif kind == "raw_stream":
        make = inference.make_raw_inference_step
        monkeypatch.setattr(inference, "make_raw_inference_step",
                            lambda *a, **k: raw_fault(fault, make(*a, **k)))
    else:
        make = steps.make_train_step
        monkeypatch.setattr(steps, "make_train_step", lambda model, *a, **k:
                            train_fault(fault, make(model, *a, **k), model))


def run(manifest, kind):
    return run_cell(f"tiny32.{kind}", 77, 0.3, False,
                    t_start=time.perf_counter(), device="cpu",
                    manifest=manifest, log=lambda *a: None)


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(manifest, kind):
    r = run(manifest, kind)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("kind", KINDS)
def test_fault_is_caught(manifest, kind, fault, monkeypatch):
    plant(monkeypatch, kind, fault)
    r = run(manifest, kind)
    assert not r["correct"], r["checks"]
