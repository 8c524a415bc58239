"""The data-parallel training cell (``traffic/tbptt_train_dp.py``) on the
CPU: two gloo ranks at gen1 tiny, one lane each, the program on its
float32 module path, held to the limits of
``rvtb_gen1.tbptt_train_dp4``. The ranks run the same calls, ``finish``
leaves none of them running a call and ``release`` none alive, the
check passes and reads the replicas equal; with one rank's gradients
left unreduced (it still takes part in the all-reduce, and keeps its own
gradients) the check fails; a rank that dies ends the run with
``failed`` above 0 instead of a hang."""
import json
import time

import pytest
import torch
import torch.distributed as dist

from benchmark.core.cell import run_cell
from benchmark.core.loop import timed_window
from benchmark.core.manifest import BENCH_DIR
from benchmark.tests.tiny import tiny_copy
from benchmark.traffic import tbptt_train_dp

CELL = "tiny32.tbptt_train_dp"
SEED = 2 ** 31 + 21


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    m = tiny_copy(tmp)
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    wl = json.loads((BENCH_DIR / "workloads" / "rvtb_gen1.tbptt_train_dp4.json"
                     ).read_text())
    wl["config"] = "tiny32"
    wl["traffic_params"].update({"ranks": 2, "lanes": 2, "pool_batches": 3,
                                 "box_side": [5, 30]})
    wl["profile"] = {"after_s": 0.0, "calls": 2}
    (m.dir / "workloads" / f"{CELL}.json").write_text(json.dumps(wl))
    spec["workloads"].append({"name": CELL, "config": "tiny32",
                              "traffic": "tbptt_train_dp", "chips": 1,
                              "why": "tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return type(m)(root=tmp, bench_dir=m.dir)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _driver(manifest):
    wl = manifest.workload(CELL)
    return tbptt_train_dp.Driver(manifest.config(wl["config"]), wl, SEED,
                                 "cpu")


def test_ranks_run_the_same_calls_and_the_check_passes(manifest):
    d = _driver(manifest)
    d.setup(0.5)
    procs = list(d.procs)
    assert len(procs) == 1 and d.mesh.world == 2 and d.lanes == slice(0, 1)
    w = timed_window(d.call, d.finish, 0.5, "cpu")
    assert w.calls == d.attempted > 0 and d.failed == 0
    # the other rank ran every call and waits for the next command
    assert int(d.store.get(f"{tbptt_train_dp.KEY}done/1")) == w.calls
    assert procs[0].poll() is None
    d.release()
    assert procs[0].poll() == 0 and not dist.is_initialized()
    readings, _ = d.check()
    assert readings["replica_mismatch"] == 0
    # the global batch's final states: both ranks' lanes, from set-up
    assert all(x.shape[0] == 2 for hc in d.s3 for x in hc)
    limits = manifest.workload(CELL)["limits"]
    assert all(readings[k] <= v for k, v in limits.items()), readings


def _run(manifest):
    return run_cell(CELL, SEED, 0.3, False, t_start=time.perf_counter(),
                    device="cpu", manifest=manifest, log=lambda *a: None)


def test_sound_run_is_correct(manifest):
    r = _run(manifest)
    assert r["correct"] and r["failed"] == 0, r["checks"]


def test_unreduced_gradients_fail_the_check(manifest, monkeypatch):
    from rvt_tpu_torch.training.optimizer import OneCycleAdamW

    def unreduced(self, group):
        dist.all_reduce(self._flat.clone(), group=group)

    monkeypatch.setattr(OneCycleAdamW, "reduce_grads", unreduced)
    r = _run(manifest)
    assert not r["correct"], r["checks"]
    assert r["checks"]["replica_mismatch"]["value"] == 1


def test_a_rank_that_dies_fails_the_run(manifest):
    d = _driver(manifest)
    d.setup(0.5)
    d.procs[0].kill()
    d.procs[0].wait()
    t0 = time.perf_counter()
    w = timed_window(d.call, d.finish, 0.5, "cpu")
    assert d.failed > 0 and d.lost and w.calls >= 0
    d.release()
    assert time.perf_counter() - t0 < 30 and not dist.is_initialized()
    assert torch.isfinite(torch.tensor(list(d.check()[0].values()))).all()
