"""The port's data parallelism (rvt_tpu_torch/parallel/) on the CPU: ranks
spawned as processes of ``rvt_tpu_torch.parallel.dryrun`` running the
scenarios of ``tests/torch_dp_scenarios.py`` (they import only the port)
over gloo with a ``file://`` store under ``tmp_path``, one torch thread
each, every spawn joined within a timeout.

  * The 2-rank dp train step against the JAX package's step over
    ``make_mesh(2)`` (``shard_batch_arrays``), the same seeded batch and
    weights (through ``convert/from_flax.py``), gen1 tiny (64, 80), f32
    module path, two carried windows: loss parts and grad_norm at
    LOSS_RTOL_F32, every gradient leaf at GRAD_TOL_F32 of its max|ref|,
    BatchNorm buffers, parameters and final states at F32_TOL
    (``tests/test_torch_modules.py``'s f32 tolerances); the two ranks'
    replicas bit for bit.
  * A 1-rank dp step (a gloo world of one in this process) equal to the
    plain step bit for bit.
  * The evaluator merge in the JAX tests' "interleave" and "empty"
    scenarios (``tests/multiproc_worker.py``) equal to the single-process
    metrics; rank-0-only side effects of the Trainer (checkpoints,
    publishes, the code snapshot, the metrics file) and of the train CLI
    under ``--multihost``; the refusals; ``dryrun_multichip(2)``;
    ``cast_params_bf16`` against JAX's; the timers.
"""
import copy
import json

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rvt_tpu.evaluation.prophesee import PropheseeEvaluator as JEvaluator
from rvt_tpu.models.backbone import zero_states as j_zero_states
from rvt_tpu.parallel.mesh import (make_mesh as j_make_mesh,
                                   replicate_tree as j_replicate_tree,
                                   shard_batch_arrays as j_shard,
                                   shard_states as j_shard_states)
from rvt_tpu.training import step as jstep
from rvt_tpu.training.optimizer import make_optimizer as j_make_optimizer
from rvt_tpu.utils.precision import cast_params_bf16 as j_cast
from rvt_tpu_torch.convert.from_flax import from_flax
from rvt_tpu_torch.evaluation.prophesee import PropheseeEvaluator
from rvt_tpu_torch.models.backbone import zero_states
from rvt_tpu_torch.models.detector import init_detector
from rvt_tpu_torch.parallel import dryrun
from rvt_tpu_torch.parallel.mesh import (DataParallel, init_process_group,
                                         make_mesh)
from rvt_tpu_torch.parallel.multihost import allgather_bytes
from rvt_tpu_torch.training.optimizer import make_optimizer
from rvt_tpu_torch.training.step import make_train_step
from rvt_tpu_torch.training.trainer import Trainer, TrainerConfig
from rvt_tpu_torch.utils import timers
from rvt_tpu_torch.utils.artifacts import ArtifactRegistry
from rvt_tpu_torch.utils.precision import cast_params_bf16
from tests.multiproc_worker import make_frames, shard_indices
from tests.test_torch_modules import (F32_TOL, GRAD_TOL_F32, LOSS_RTOL_F32,
                                      _batch, _close, bridged)
from tests.test_torch_trainer import batches as trainer_batches
from tests.test_torch_trainer import tiny_cfg
from tests.torch_dp_scenarios import scenario

TIMEOUT = 600  # seconds a spawn may take (~5-15 s each here)
PARTS = ("loss", "iou_loss", "conf_loss", "cls_loss", "num_fg", "grad_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the ranks have: the suite runs in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_batches():
    """Two windows of four lanes (two a rank): test_torch_train_step.py's
    batch twice over, the first restarting lanes 0, 2 and 3."""
    rng = np.random.RandomState(0)
    out = []
    for first in ([True, False, True, True], [False] * 4):
        a, b = _batch(rng), _batch(rng)
        out.append(tuple(np.concatenate([x, y]) for x, y in zip(a, b))
                   + (np.array(first),))
    return out


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The port's 2-rank dp steps and JAX's 2-device mesh steps, from the
    bridged f32 weights, over ``_global_batches``."""
    cfg, model, variables, tcfg, tmodel = bridged("float32")
    batches = _global_batches()
    # JAX: the global batch sharded over a 2-device dp mesh under jit
    opt = j_make_optimizer(cfg.training)
    params = variables["params"]
    mesh = j_make_mesh(2)
    state = j_replicate_tree(mesh, jstep.TrainState(
        params=params, batch_stats=variables["batch_stats"],
        opt_state=opt.init(params), step=jnp.zeros((), jnp.int32)))
    jst = j_shard_states(mesh, j_zero_states(cfg.model.backbone, 4))
    jtrain = jstep.make_train_step(model, cfg, opt, donate=False, mesh=mesh)
    jout, grads = [], None
    with mesh:
        for b in batches:
            state, jst, jm = jtrain(state, jst, *j_shard(mesh, *b))
            jout.append({k: float(v) for k, v in jm.items()})
            if grads is None:
                gn = jout[0]["grad_norm"]
                mu = np.asarray(state.opt_state[1][0].mu, np.float64)
                g = mu / (1.0 - 0.9) * (gn if gn >= 1.0 else 1.0)
                unravel = jax.flatten_util.ravel_pytree(params)[1]
                grads = from_flax({"params": jax.tree.map(
                    np.asarray, unravel(jnp.asarray(g, jnp.float32)))})
    jstate = from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    # the port: two ranks, two lanes each
    ranks = dryrun.spawn(
        [(scenario("train_steps"), dict(cfg=tcfg, state=tmodel.state_dict(),
                                        batches=batches))],
        2, tmp_path_factory.mktemp("dp"), device="cpu", timeout=TIMEOUT)
    return dict(jout=jout, jgrads=grads, jstate=jstate,
                jstates=jax.tree.map(np.asarray, jst),
                ranks=[r[0] for r in ranks])


def test_dp_step_matches_jax_mesh_step(dp_runs):
    """Two ranks of the port's dp step against JAX's step over a 2-device
    mesh: the same global-batch function (loss over the global
    foreground count, BatchNorm over every rank's frames, one gradient)."""
    r0, r1 = dp_runs["ranks"]
    for jm, m0, m1 in zip(dp_runs["jout"], r0["metrics"], r1["metrics"]):
        assert m0 == m1  # every rank reports the global numbers
        for k in PARTS:
            np.testing.assert_allclose(m0[k], jm[k], rtol=LOSS_RTOL_F32,
                                       err_msg=k)
        assert m0["num_fg"] > 0 and m0["loss"] > 0
    grads = r0["grads"]  # JAX's read from its first Adam moment
    assert set(grads) == set(dp_runs["jgrads"])
    for name, ref in dp_runs["jgrads"].items():
        _close(grads[name], ref.numpy(), GRAD_TOL_F32)
    state = r0["state"]
    for name, ref in dp_runs["jstate"].items():
        _close(state[name], ref.numpy(), F32_TOL)
    # each rank's final LSTM states are its lanes of JAX's
    for r, lanes in ((r0, slice(0, 2)), (r1, slice(2, 4))):
        for (jh, jc), (h, c) in zip(dp_runs["jstates"], r["states"]):
            _close(h, jh[lanes], F32_TOL)
            _close(c, jc[lanes], F32_TOL)


def test_dp_replicas_bit_identical(dp_runs):
    """After every step the two ranks' parameters and buffers are the
    same bit for bit (rank 0's broadcast compared on each rank)."""
    for r in dp_runs["ranks"]:
        assert len(r["replicas"]) == 2 and all(r["replicas"])


def test_one_rank_dp_step_is_the_plain_step(tmp_path):
    """With one rank every collective is the identity: the dp step (a
    gloo world of one) equals the plain step bit for bit over two
    windows: metrics, gradients, parameters, BatchNorm buffers, moments
    and final states."""
    _, _, _, tcfg, tmodel = bridged("float32")
    batches = [tuple(a[:2] for a in b) for b in _global_batches()]
    init_process_group("cpu", init_method=f"file://{tmp_path}/store",
                       rank=0, world_size=1)
    try:
        runs = []
        for group in (None, make_mesh().group):
            model = copy.deepcopy(tmodel)
            opt = make_optimizer(model.parameters(), tcfg.training)
            step = make_train_step(model, tcfg, opt, group=group)
            states = zero_states(tcfg.model.backbone, 2, device="cpu")
            metrics = []
            for b in batches:
                states, m = step(states, *(torch.from_numpy(a) for a in b))
                metrics.append(m)
            runs.append((model, opt, states, metrics))
    finally:
        dist.destroy_process_group()
    (ma, oa, sa, xa), (mb, ob, sb, xb) = runs
    assert group is not None
    for a, b in zip(xa, xb):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    pa, pb = ma.state_dict(), mb.state_dict()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    for (_, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p.grad, q.grad)
    assert all(torch.equal(x, y) for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu))
    assert all(torch.equal(x, y) for hx, hy in zip(sa, sb)
               for x, y in zip(hx, hy))


@pytest.mark.parametrize("payload", [b"", b"\x00\x01", bytes(range(256))])
def test_allgather_bytes_one_process(payload):
    assert allgather_bytes(payload) == [payload]


def test_evaluator_merge_and_rank0_marker(tmp_path):
    """The JAX multi-process test's scenarios: frames dealt round-robin
    ("interleave"), and rank 0 holding everything while rank 1 sends an
    empty buffer ("empty"); both ranks' merged metrics equal the
    single-process metrics of the full set (the port's and JAX's), both
    ranks hold the same merged buffer (rank 0's frames first), and only
    rank 0 writes its marker."""
    gt, pred = make_frames(10)
    full = PropheseeEvaluator("gen1")
    full.add_labels(gt)
    full.add_predictions(pred)
    oracle = full.evaluate_buffer(64, 80)
    jfull = JEvaluator("gen1")
    jfull.add_labels(gt)
    jfull.add_predictions(pred)
    joracle = jfull.evaluate_buffer(64, 80)
    assert oracle["AP"] > 0.1
    for k, v in joracle.items():
        np.testing.assert_allclose(oracle[k], v, atol=1e-12, err_msg=k)
    scenarios = []
    for name in ("interleave", "empty"):
        (tmp_path / name).mkdir()
        per_rank = {r: dict(labels=[gt[i] for i in shard_indices(10, r, 2,
                                                                 name)],
                            preds=[pred[i] for i in shard_indices(10, r, 2,
                                                                  name)])
                    for r in range(2)}
        scenarios.append((scenario("eval_merge"), dict(
            labels=None, preds=None, marker_dir=str(tmp_path / name),
            per_rank=per_rank)))
    # the zero-length payload edge of the byte exchange itself
    scenarios.append((scenario("allgather"),
                      dict(payloads=[b"rank 0", b""])))
    results = dryrun.spawn(scenarios, 2, tmp_path / "ranks", device="cpu",
                           timeout=TIMEOUT)
    assert [r[-1] for r in results] == [[b"rank 0", b""]] * 2
    for r, res in enumerate(results):
        for name, m in zip(("interleave", "empty"), res):
            for k, v in oracle.items():
                np.testing.assert_allclose(m["metrics"][k], v, atol=1e-12,
                                           err_msg=f"rank {r} {name} {k}")
    # both ranks hold the same merged buffer: rank 0's frames, then 1's
    for i in range(2):
        assert results[0][i]["buffer"] == results[1][i]["buffer"]
    ordered = PropheseeEvaluator("gen1")
    for r in range(2):
        idx = shard_indices(10, r, 2, "interleave")
        shard = PropheseeEvaluator("gen1")
        shard.add_labels([gt[i] for i in idx])
        shard.add_predictions([pred[i] for i in idx])
        ordered.extend_from_bytes(shard.state_bytes())
    assert ordered.state_bytes() == results[0][0]["buffer"]
    for name in ("interleave", "empty"):
        assert sorted(p.name for p in (tmp_path / name).iterdir()) == \
            ["ckpt_rank0"]


def _log_lines(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _side_effects(run):
    """What a Trainer run wrote: its checkpoint steps, the registry's
    versions (step and number) and aliases, the code snapshots, panels
    and the steps of each metrics line."""
    reg = ArtifactRegistry(run / "registry")
    return dict(
        steps=sorted(p.name for p in (run / "steps").iterdir()),
        versions=[v["step"] for v in reg.versions("checkpoint")],
        aliases=reg.aliases("checkpoint"),
        code=len(reg.versions("checkpoint-code")),
        panels=len(list((run / "viz").glob("step_*.png"))),
        lines=[(x["step"], sorted(x)) for x in _log_lines(
            run / "metrics.jsonl")])


def test_trainer_dp_writes_side_effects_on_rank0(tmp_path):
    """``Trainer.fit`` over two ranks (one lane each of the global batch),
    checkpoints every step published to a registry, train-time detection
    metrics merged over the ranks, panels: every checkpoint, publish,
    snapshot, panel and metrics line is written once, by rank 0, the
    side effects of one process on the same batches; the replicas equal
    after; the logged loss parts those of one process on the global
    batch."""
    cfg = tiny_cfg(conf=0.0)
    data = list(trainer_batches(cfg, 2))
    kw = dict(max_steps=2, log_every_n_steps=1, ckpt_every_n_steps=1,
              gradflow_every_n_steps=0, detection_metrics_every_n_steps=2,
              detection_metrics_n_batches=1, prefetch_depth=0,
              train_viz_max_panels=1)

    def trainer_kw(run):
        return dict(kw, ckpt_dir=str(run), artifact_dir=str(run / "registry"),
                    train_viz_dir=str(run / "viz"))

    state = init_detector(cfg.model, seed=0, device="cpu").state_dict()
    results = dryrun.spawn([(scenario("trainer_fit"), dict(
        cfg=cfg, state=state, batches=data,
        trainer_kw=trainer_kw(tmp_path / "dp")))], 2, tmp_path / "ranks",
        device="cpu", timeout=TIMEOUT)
    (r0,), (r1,) = results
    assert r0["replicas"] and r1["replicas"]
    assert {k: v for k, v in r0["last"].items() if k in PARTS} == \
        {k: v for k, v in r1["last"].items() if k in PARTS}
    one = Trainer(cfg, TrainerConfig(**trainer_kw(tmp_path / "one")),
                  model=init_detector(cfg.model, seed=0, device="cpu"),
                  device="cpu")
    one.fit(iter(data))
    dp, ref = _side_effects(tmp_path / "dp"), _side_effects(tmp_path / "one")
    assert dp == ref
    # two publishes (v1 pruned by top-1 retention, v2 the last): rank 1
    # published nothing
    assert dp["steps"] == ["1", "2"] and dp["versions"] == [2]
    assert dp["aliases"]["last"] == 2
    assert dp["code"] == 1 and dp["panels"] == 1
    assert [s for s, keys in dp["lines"] if "train/AP" in keys] == [2]
    for a, b in zip(*(_log_lines(tmp_path / r / "metrics.jsonl")
                      for r in ("dp", "one"))):
        for k in PARTS:
            if f"train/{k}" in b:
                np.testing.assert_allclose(a[f"train/{k}"], b[f"train/{k}"],
                                           rtol=LOSS_RTOL_F32, err_msg=k)


def test_train_cli_multihost(tmp_path_factory):
    """``cli/train.py --multihost`` in a world of two (gloo, CPU): one
    step with validation, each rank evaluating its shard of the two val
    recordings; both ranks get the same merged metrics, equal to one
    process evaluating both recordings with the checkpoint rank 0 wrote
    once."""
    from rvt_tpu_torch.cli import train as t_train
    from rvt_tpu_torch.config import preset
    from rvt_tpu_torch.utils.checkpoint import CheckpointManager

    from .test_torch_train_cli import KW
    from .test_torch_train_data import make_train_set

    data = make_train_set(tmp_path_factory.mktemp("dp_cli_set"), splits=(
        ("train", ("a", "b")), ("val", ("v", "w"))))
    tmp = tmp_path_factory.mktemp("dp_cli")
    argv = ["--dataset", "gen1", "--size", "tiny", "--data_dir", str(data),
            "--batch_size", "2", "--log_every", "1", "--max_steps", "1",
            "--val_every", "1", "--ckpt_dir", str(tmp / "run"),
            "--multihost", "--device", "cpu"]
    results = dryrun.spawn(
        [(scenario("train_cli"), dict(argv=argv, preset_kw=KW))], 2,
        tmp / "ranks", device="cpu", timeout=TIMEOUT)
    (r0,), (r1,) = results
    assert len(r0["val"]) == 1 and r0["val"] == r1["val"]
    lines = _log_lines(tmp / "run" / "metrics.jsonl")
    assert [x["step"] for x in lines] == [1, 1]  # train, val: once each
    mgr = CheckpointManager(tmp / "run")
    assert mgr.latest_step() == 1
    cfg = preset("gen1", "tiny", **KW)
    cfg = cfg.__class__(**{**cfg.__dict__, "batch_size": cfg.batch_size
                           .__class__(train=2, eval=2)})
    model = init_detector(cfg.model, seed=0, device="cpu")
    model.load_state_dict(mgr.restore(map_location="cpu")["model"])
    ref = t_train.make_eval_fn(cfg, t_train.build_streams(data, "val", cfg),
                               device="cpu")(model)
    assert set(ref) == set(r0["val"][0])
    for k, v in ref.items():
        np.testing.assert_allclose(r0["val"][0][k], v, rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_dp_refusals():
    """A batch the world does not divide raises ValueError naming both
    numbers, as JAX's sharding refuses it; a dp_size other than the
    world's raises, saying how to launch; so does the Trainer."""
    with pytest.raises(ValueError, match="divisible"):
        j_shard(j_make_mesh(2), np.zeros((3, 4)))
    two = DataParallel(None, 1, 2, "gloo")
    with pytest.raises(ValueError, match="3 lanes .* 2 data-parallel"):
        two.lanes(3)
    assert np.arange(4)[two.lanes(4)].tolist() == [2, 3]
    with pytest.raises(ValueError, match="launch dp_size processes"):
        make_mesh(2)
    assert make_mesh(-1).world == make_mesh(1).world == 1
    with pytest.raises(ValueError, match="torchrun"):
        Trainer(tiny_cfg(), TrainerConfig(), dp_size=4, device="cpu")


def test_spawn_fails_with_a_rank(tmp_path):
    """A rank that fails (here: a scenario it does not know) fails the
    spawn at once with the end of its log, and no rank is left running."""
    with pytest.raises(RuntimeError, match="failed .exit 1.:"):
        dryrun.spawn([(scenario("no_such_scenario"), {})], 2, tmp_path,
                     device="cpu", timeout=60)


def test_spawn_defaults_to_the_card(tmp_path, monkeypatch):
    """``spawn`` runs its ranks on the card unless the caller asks for
    the CPU, as every entry point of the port: without a card the
    default raises before a rank starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.spawn([(scenario("allgather"), dict(payloads=[b""] * 2))],
                     2, tmp_path)
    assert not list(tmp_path.iterdir())


def test_dryrun_multichip_two_ranks(tmp_path):
    line = dryrun.dryrun_multichip(2, device="cpu", workdir=tmp_path,
                                   timeout=TIMEOUT)
    assert line.endswith("OK") and "modules:" in line and "kernels:" in line


def test_cast_params_bf16_matches_jax():
    """Floating parameters to bf16, BatchNorm statistics kept in f32, as
    JAX's ``cast_params_bf16`` does to the same flax variables."""
    _, _, variables, _, tmodel = bridged("float32")
    ref = from_flax(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                 if a.dtype == jnp.bfloat16
                                 else np.asarray(a), j_cast(variables)))
    got = cast_params_bf16(tmodel.state_dict())
    assert set(got) == set(ref)
    n_bn = 0
    for k, v in got.items():
        bn = k.endswith(("running_mean", "running_var"))
        n_bn += bn
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.int64
            continue
        assert v.dtype == (torch.float32 if bn else torch.bfloat16), k
        np.testing.assert_array_equal(v.float().numpy(), ref[k].numpy(),
                                      err_msg=k)
    assert n_bn > 0


def test_timers_summary():
    """Spans nest and sum by name (self time: a span's host time less its
    children's), counters sum over their items, each record under its
    parent and call id; with tracing off a span records nothing; reset
    drops the records."""
    timers.reset()
    timers.enable(True)
    try:
        for _ in range(3):
            call = timers.next_call()
            with timers.span("test_parallel/host", "cpu"):
                with timers.span("test_parallel/inner"):
                    sum(range(1000))
                timers.add_count("test_parallel/count", 2, items=4)
    finally:
        timers.enable(False)
    with timers.span("test_parallel/off"):
        pass
    recs = timers.records()
    assert [r.name for r in recs[-3:]] == ["test_parallel/host",
                                           "test_parallel/inner",
                                           "test_parallel/count"]
    assert {r.call for r in recs[-3:]} == {call}
    assert [r.parent for r in recs[-3:]] == [None, "test_parallel/host",
                                             "test_parallel/host"]
    s = timers.summary()
    host, inner = (s["spans"][f"test_parallel/{n}"] for n in ("host",
                                                              "inner"))
    assert host["count"] == inner["count"] == 3
    assert 0 < inner["host_s"] <= host["host_s"]
    assert host["self_s"] == pytest.approx(host["host_s"]
                                           - inner["host_s"])
    assert host["device_count"] == 0  # host work: no device interval
    assert s["counters"]["test_parallel/count"] == {"sum": 6, "items": 12,
                                                    "count": 3}
    assert "test_parallel/off" not in s["spans"]
    timers.reset()
    assert timers.records() == [] and timers.summary()["spans"] == {}
