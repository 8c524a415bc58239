"""The port's training-data copies (rvt_tpu_torch.data: augmentor,
random_access, psee_loader; rvt_tpu_torch.registry) against the JAX
package's, bit for bit on the CPU: the augmentor's draws and arrays over
windows of recordings that the JAX package's preprocess writes, the
class-frequency weights, the random-access and mixed schedulers' plans
and batches, the lane split, the .dat readers and the registries; and
the reference-free cases of tests/test_labels_augmentor.py and
tests/test_random_mixed.py on the port's modules."""
import random
from dataclasses import asdict, fields

import numpy as np
import pytest
import torch

from rvt_tpu import registry as j_registry
from rvt_tpu.data import augmentor as j_aug
from rvt_tpu.data import psee_loader as j_psee
from rvt_tpu.data import random_access as j_ra
from rvt_tpu.data import sequence as j_seq
from rvt_tpu.data import streaming as j_stream
from rvt_tpu_torch import registry as t_registry
from rvt_tpu_torch.data import augmentor as t_aug
from rvt_tpu_torch.data import psee_loader as t_psee
from rvt_tpu_torch.data import random_access as t_ra
from rvt_tpu_torch.data import sequence as t_seq
from rvt_tpu_torch.data import streaming as t_stream

from .test_data_pipeline import BBOX_DTYPE

REPR = "stacked_histogram_dt=50_nbins=10"
HW = (64, 80)
T = 5


def make_train_set(root, hw=HW, splits=(("train", ("a", "b", "c")),
                                        ("val", ("v",))), n_events=60_000):
    """Recordings that ``rvt_tpu.cli.preprocess`` writes under
    ``<root>/<split>/<name>`` at ``hw`` (gen1's geometry shrunk): random
    events over 2.5 s and one to three boxes of random size (class 1 at
    odds of 3 in 10, else 0) on every 4 Hz label frame from 0.6 s.
    Returns ``root``."""
    import h5py

    from rvt_tpu.cli import preprocess as pp

    H, W = hw
    old = pp.DATASET_HW["gen1"]
    pp.DATASET_HW["gen1"] = (H, W)
    raw = root / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    try:
        seed = 0
        for split, names in splits:
            for name in names:
                rng = np.random.RandomState(seed)
                seed += 1
                t = np.sort(rng.randint(0, 2_500_000, n_events))
                h5f = raw / f"{name}_td.dat.h5"
                with h5py.File(str(h5f), "w") as f:
                    g = f.create_group("events")
                    g.create_dataset("x", data=rng.randint(0, W, n_events)
                                     .astype(np.uint16))
                    g.create_dataset("y", data=rng.randint(0, H, n_events)
                                     .astype(np.uint16))
                    g.create_dataset("p", data=rng.randint(0, 2, n_events)
                                     .astype(np.int8))
                    g.create_dataset("t", data=t.astype(np.int64))
                    g.create_dataset("height", data=H)
                    g.create_dataset("width", data=W)
                rows = []
                for ts in range(600_000, 2_500_000, 250_000):
                    for _ in range(rng.randint(1, 4)):
                        w, h = rng.randint(8, W // 2), rng.randint(8, H // 2)
                        rows.append((ts, rng.randint(0, W - w),
                                     rng.randint(0, H - h), w, h,
                                     int(rng.rand() < 0.3), 0, 1.0))
                npy = raw / f"{name}_bbox.npy"
                np.save(str(npy), np.array(rows, dtype=BBOX_DTYPE))
                assert pp.process_recording(npy, h5f, root / split / name,
                                            "gen1", split)
    finally:
        pp.DATASET_HW["gen1"] = old
    return root


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_train_set(tmp_path_factory.mktemp("train_set")) / "train"


def _recs(module, data):
    return [module.Recording(p, REPR, original_hw=HW, max_labels_per_frame=8)
            for p in sorted(data.iterdir())]


def _rnd_views(module, data, end_labels=False):
    return [module.RandomAccessView(r, T, only_load_end_labels=end_labels)
            for r in _recs(module, data)]


def _streams(module, data):
    return [s for r in _recs(module, data)
            for s in module.StreamView.with_guaranteed_labels(r, T)]


def _same_window(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _same_batch(a, b) -> None:
    for f in fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _same_plans(a, b) -> None:
    """WindowPlans of the two packages: the same fields, the augmentation
    states field by field."""
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p.stream_idx, p.window_idx, p.aug_seed, p.source) == (
            q.stream_idx, q.window_idx, q.aug_seed, q.source)
        assert (p.aug_state is None) == (q.aug_state is None)
        if p.aug_state is not None:
            assert asdict(p.aug_state) == asdict(q.aug_state)


# -- registry ----------------------------------------------------------------


def test_registry_equals_jax():
    from rvt_tpu_torch.models.backbone import RVTBackbone
    from rvt_tpu_torch.models.detector import RVTDetector

    for name in ("gen1", "gen4"):
        for size in ("tiny", "base"):
            assert asdict(t_registry.dataset_preset(name, size)) == asdict(
                j_registry.dataset_preset(name, size))
    cfg = t_registry.dataset_preset("gen1", "tiny", resolution_hw=HW)
    assert asdict(cfg) == asdict(j_registry.dataset_preset(
        "gen1", "tiny", resolution_hw=HW))
    model = t_registry.build_model(cfg.model)
    assert type(model) is RVTDetector and model.cfg == cfg.model
    backbone = t_registry.build_backbone(cfg.model.backbone)
    assert type(backbone) is RVTBackbone
    assert backbone.state_dict().keys() == model.backbone.state_dict().keys()
    for mod in (t_registry, j_registry):
        with pytest.raises(NotImplementedError):
            mod.build_model(cfg.model, name="yolo")
        with pytest.raises(NotImplementedError):
            mod.dataset_preset("kitti")


# -- augmentor ---------------------------------------------------------------


def test_resize_and_rotate_equal_jax():
    rng = np.random.RandomState(0)
    for shape, out in (((3, 24, 36), (12, 18)), ((2, 5, 48, 64), (61, 77)),
                       ((4, 17, 23), (40, 9))):
        img = rng.randint(0, 255, size=shape).astype(np.uint8)
        np.testing.assert_array_equal(t_aug.nearest_exact_resize(img, out),
                                      j_aug.nearest_exact_resize(img, out))
        for angle in (-6.0, -2.5, 3.7, 6.0, 90.0):
            a = t_aug.rotate_nearest(img, angle)
            assert a.dtype == img.dtype
            np.testing.assert_array_equal(a, j_aug.rotate_nearest(img, angle))


AUG_MODES = {
    # the shipped presets (SpatialAugmentor.for_mode) and one that rotates
    "stream": dict(mode="stream"),
    "random": dict(mode="random"),
    "rotate": dict(rotate_prob=1.0, zoom_prob=0.5),
}


@pytest.mark.parametrize("kind", sorted(AUG_MODES))
def test_augmentor_equals_jax(data, kind):
    """``sample_state`` and ``apply`` over 24 seeds: the same draws give the
    same state, and the same window the same arrays."""
    from rvt_tpu.config import preset as j_preset
    from rvt_tpu_torch.config import preset as t_preset

    opts = AUG_MODES[kind]
    if "mode" in opts:
        t = t_aug.SpatialAugmentor.for_mode(
            t_preset("gen1", "tiny", resolution_hw=HW).dataset, opts["mode"])
        j = j_aug.SpatialAugmentor.for_mode(
            j_preset("gen1", "tiny", resolution_hw=HW).dataset, opts["mode"])
    else:
        t, j = t_aug.SpatialAugmentor(HW, **opts), j_aug.SpatialAugmentor(
            HW, **opts)
    assert vars(t) == vars(j)
    windows = [v[i] for v in _rnd_views(t_seq, data) for i in range(len(v))]
    seen = {"h_flip": 0, "rotate_deg": 0, "zoom_in_factor": 0, "zoom_out": 0}
    for seed in range(24):
        allow = opts.get("mode") != "stream"
        st = t.sample_state(random.Random(seed), allow_zoom_in=allow)
        jst = j.sample_state(random.Random(seed), allow_zoom_in=allow)
        assert asdict(st) == asdict(jst)
        for k in seen:
            seen[k] += bool(getattr(st, k))
        w = windows[seed % len(windows)]
        got = t.apply(dict(w), st, random.Random(seed + 100))
        want = j.apply(dict(w), jst, random.Random(seed + 100))
        _same_window(got, want)
    assert seen["h_flip"] and (seen["zoom_in_factor"] or seen["zoom_out"])
    if kind == "rotate":
        assert seen["rotate_deg"]


def test_class_frequency_weights_equal_jax(data):
    w = t_ra.class_frequency_weights(_rnd_views(t_seq, data))
    ref = j_ra.class_frequency_weights(_rnd_views(j_seq, data))
    assert w.dtype == ref.dtype and len(w) > 8
    np.testing.assert_array_equal(w, ref)
    assert len(np.unique(w)) > 1


# -- schedulers --------------------------------------------------------------


def _first(sched, n=4):
    it = iter(sched)
    return [next(it) for _ in range(n)]


def _first_plans(sched, n=4):
    it = sched.plan_batches()
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["uniform", "weighted"])
@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augmented"])
def test_random_access_scheduler_equals_jax(data, weighted, augment):
    def make(ra, seq, aug):
        fn = aug.SpatialAugmentor(HW) if augment else None
        return ra.RandomAccessScheduler(_rnd_views(seq, data), 3, seed=5,
                                        weighted=weighted, augment_fn=fn)

    t, j = make(t_ra, t_seq, t_aug), make(j_ra, j_seq, j_aug)
    if weighted:
        np.testing.assert_array_equal(t.weights, j.weights)
    for a, b in zip(_first_plans(t), _first_plans(j)):
        _same_plans(a, b)
    t, j = make(t_ra, t_seq, t_aug), make(j_ra, j_seq, j_aug)
    for a, b in zip(_first(t), _first(j)):
        _same_batch(a, b)
        assert a.is_first_sample.all()


@pytest.mark.parametrize("total", [2, 5, 8])
def test_mixed_scheduler_equals_jax(data, total):
    def make(ra, seq, stream, aug):
        n_stream, n_random = ra.split_batch_size(total)
        return ra.MixedScheduler(
            stream.TrainStreamScheduler(
                _streams(seq, data), n_stream, seed=0,
                augment_fn=aug.SpatialAugmentor(HW, zoom_prob=0.5,
                                                zoom_in_weight=0.0,
                                                zoom_out_weight=1.0)),
            ra.RandomAccessScheduler(_rnd_views(seq, data), n_random, seed=1,
                                     augment_fn=aug.SpatialAugmentor(HW)))

    def pair():
        return (make(t_ra, t_seq, t_stream, t_aug),
                make(j_ra, j_seq, j_stream, j_aug))

    t, j = pair()
    assert t.batch_size == j.batch_size == total
    for a, b in zip(_first_plans(t), _first_plans(j)):
        _same_plans(a, b)
        assert [p.source for p in a] == [0] * t.stream.batch_size + [1] * (
            t.random.batch_size)
    t, j = pair()
    for a, b in zip(_first(t), _first(j)):
        _same_batch(a, b)


def test_split_batch_size_equals_jax():
    for total in range(2, 17):
        for ws, wr in ((1.0, 1.0), (3.0, 1.0), (1.0, 4.0), (0.0, 1.0)):
            assert t_ra.split_batch_size(total, ws, wr) == \
                j_ra.split_batch_size(total, ws, wr)


# -- .dat / .npy readers -----------------------------------------------------


def test_psee_loaders_equal_jax(tmp_path):
    """A file ``write_dat`` writes is the JAX package's byte for byte, and
    both packages' loaders read the same events from it through every
    seek."""
    rng = np.random.RandomState(0)
    n = 5000
    t = np.sort(rng.randint(0, 2_000_000, n))
    x, y, p = (rng.randint(0, 304, n), rng.randint(0, 240, n),
               rng.randint(0, 2, n))
    t_psee.write_dat(tmp_path / "a_td.dat", t, x, y, p, 240, 304)
    j_psee.write_dat(tmp_path / "b_td.dat", t, x, y, p, 240, 304)
    assert (tmp_path / "a_td.dat").read_bytes() == (
        tmp_path / "b_td.dat").read_bytes()
    a, b = t_psee.PSEELoader(tmp_path / "a_td.dat"), j_psee.PSEELoader(
        tmp_path / "a_td.dat")
    try:
        for attr in ("ev_type", "ev_size", "height", "width",
                     "total_time_us"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert a.event_count() == b.event_count() == n
        for op, arg in (("load_n_events", 700), ("load_delta_t", 100_000),
                        ("seek_time", 1_000_000), ("load_delta_t", 55_555),
                        ("seek_event", 4990), ("load_delta_t", 10 ** 7),
                        ("load_delta_t", 10), ("seek_event", 12),
                        ("load_n_events", 10 ** 6)):
            ra, rb = getattr(a, op)(arg), getattr(b, op)(arg)
            if ra is not None:
                assert set(ra) == set(rb) == {"t", "x", "y", "p"}
                for k in ra:
                    assert ra[k].dtype == rb[k].dtype
                    np.testing.assert_array_equal(ra[k], rb[k])
            assert a.current_event_index() == b.current_event_index()
            assert a.done() == b.done()
    finally:
        a.close()
        b.close()
    arr = np.zeros(4, [("ts", "<u8"), ("x", "<f4"), ("confidence", "<f4")])
    arr["ts"] = [1, 2, 3, 4]
    np.save(tmp_path / "legacy.npy", arr)
    got, want = (t_psee.load_npy_events(tmp_path / "legacy.npy"),
                 j_psee.load_npy_events(tmp_path / "legacy.npy"))
    assert got.dtype == want.dtype
    assert got.dtype.names == ("t", "x", "class_confidence")
    np.testing.assert_array_equal(got, want)


# -- the reference-free cases of test_labels_augmentor.py / test_random_mixed


def test_nearest_exact_resize_matches_torch():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, size=(3, 24, 36)).astype(np.uint8)
    for size in ((12, 18), (48, 72)):
        ref = torch.nn.functional.interpolate(
            torch.from_numpy(img)[None].float(), size=size,
            mode="nearest-exact")[0].numpy().astype(np.uint8)
        np.testing.assert_array_equal(t_aug.nearest_exact_resize(img, size),
                                      ref)


def _window(rng, T=3, M=6, H=48, W=64):
    ev = rng.randint(0, 5, size=(T, 4, H, W)).astype(np.uint8)
    labels = np.zeros((T, M, 7), np.float32)
    mask = np.zeros((T, M), bool)
    labels[1, 0] = (1000, 5.0, 8.0, 20.0, 16.0, 0, 1.0)
    mask[1, 0] = True
    labels[2, 0] = (1500, 30.0, 20.0, 18.0, 14.0, 1, 1.0)
    mask[2, 0] = True
    return {"ev_repr": ev, "labels": labels, "label_mask": mask,
            "frame_valid": mask.any(-1), "is_first_sample": np.asarray(True),
            "is_padded": np.zeros(T, bool)}


def test_augmentor_hflip_consistency():
    w = _window(np.random.RandomState(0))
    aug = t_aug.SpatialAugmentor((48, 64), prob_hflip=1.0, zoom_prob=0.0)
    st = aug.sample_state(random.Random(0))
    assert st.h_flip
    out = aug.apply(w, st)
    np.testing.assert_array_equal(out["ev_repr"], w["ev_repr"][..., ::-1])
    assert out["labels"][1, 0][1] == 64 - 1 - 5.0 - 20.0
    assert out["ev_repr"].sum() == w["ev_repr"].sum()


def test_augmentor_zoom_out_consistency():
    w = _window(np.random.RandomState(1))
    aug = t_aug.SpatialAugmentor((48, 64), prob_hflip=0.0, zoom_prob=1.0,
                                 zoom_in_weight=0.0, zoom_out_weight=1.0,
                                 zoom_out_min=1.2, zoom_out_max=1.2)
    st = aug.sample_state(random.Random(3))
    assert st.zoom_out is not None
    out = aug.apply(w, st)
    assert out["ev_repr"].shape == w["ev_repr"].shape
    lab = out["labels"][out["label_mask"]]
    assert np.all(lab[:, 1] >= 0) and np.all(lab[:, 1] + lab[:, 3] <= 64)


def test_augmentor_zoom_in_keeps_a_label():
    w = _window(np.random.RandomState(2))
    aug = t_aug.SpatialAugmentor((48, 64), prob_hflip=0.0, zoom_prob=1.0,
                                 zoom_in_weight=1.0, zoom_out_weight=0.0,
                                 zoom_in_min=1.4, zoom_in_max=1.4)
    st = aug.sample_state(random.Random(1), allow_zoom_in=True)
    assert st.zoom_in_factor is not None
    out = aug.apply(w, st, random.Random(2))
    assert out["label_mask"][2].any()


def test_psee_dat_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    n = 1000
    t = np.sort(rng.randint(0, 1_000_000, n))
    x, y, p = (rng.randint(0, 304, n), rng.randint(0, 240, n),
               rng.randint(0, 2, n))
    path = tmp_path / "events_td.dat"
    t_psee.write_dat(path, t, x, y, p, height=240, width=304)
    loader = t_psee.PSEELoader(path)
    assert loader.event_count() == n
    assert loader.height == 240 and loader.width == 304
    ev = loader.load_n_events(n)
    for k, v in (("x", x), ("y", y), ("p", p), ("t", t)):
        np.testing.assert_array_equal(ev[k], v)
    loader.seek_event(0)
    assert len(loader.load_delta_t(100_000)["t"]) == (t < t[0] + 100_000).sum()
    loader.close()


def test_random_scheduler(data):
    sched = t_ra.RandomAccessScheduler(_rnd_views(t_seq, data), 3, seed=0)
    for b in _first(sched):
        b.validate()
        assert b.is_first_sample.all()  # state reset every batch
        assert b.frame_valid[:, -1].all()  # windows end at labelled frames


def test_weighted_sampling_weights(data):
    views = _rnd_views(t_seq, data)
    w = t_ra.class_frequency_weights(views)
    assert len(w) == sum(len(v) for v in views)
    assert np.all(w > 0)
    sched = t_ra.RandomAccessScheduler(views, 2, seed=0, weighted=True)
    next(iter(sched)).validate()


def test_mixed_scheduler_layout(data):
    n_stream, n_random = t_ra.split_batch_size(4)
    assert (n_stream, n_random) == (2, 2)
    mixed = t_ra.MixedScheduler(
        t_stream.TrainStreamScheduler(_streams(t_seq, data), n_stream,
                                      seed=0),
        t_ra.RandomAccessScheduler(_rnd_views(t_seq, data), n_random,
                                   seed=1))
    assert mixed.batch_size == 4
    b0, b1 = _first(mixed, 2)
    b0.validate()
    assert b0.is_first_sample[n_stream:].all()
    assert b1.is_first_sample[n_stream:].all()
    assert not b1.is_first_sample[:n_stream].any()  # streams continue
