"""The port's preprocessing (rvt_tpu_torch.cli.preprocess, native_lib,
and ops/voxelization.py's mixed_density_stack and
repair_time_monotonicity) against the JAX package's, bit for bit on the
CPU: ``process_recording`` on the same synthetic raw recording in both
representations, duration and count windows, ``--downsample_by_2``,
fastmode on and off, every compression, native and numpy voxelizers,
every output array and the HDF5 layout identical; the re-run checks;
``main`` with its spawn pool against JAX's ``main``; the native COCO
matcher against the numpy one inside the port's coco.py."""
import os

import h5py
import numpy as np
import pytest
import torch

from rvt_tpu import native_lib as j_native
from rvt_tpu.cli import preprocess as j_pp
from rvt_tpu_torch import native_lib as t_native
from rvt_tpu_torch.cli import preprocess as t_pp
from rvt_tpu_torch.data import blosc_h5

from .test_data_pipeline import BBOX_DTYPE

HW = (48, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_raw(raw, name, hw=HW, seconds=1.6, n_events=40_000, seed=0):
    """A raw ``<name>_td.dat.h5`` + ``<name>_bbox.npy`` pair: uniform
    events with a few timestamps out of order (the reader's running max
    repairs them), 600 more events on pixel (y 7, x 5) inside 3 ms (past
    uint8 in one bin, so fastmode wraps) and boxes at 4 Hz from 0.6 s,
    among them boxes the filters crop or drop (too narrow, frame-wide)."""
    rng = np.random.RandomState(seed)
    H, W = hw
    n = n_events
    t = rng.randint(0, int(seconds * 1e6), n + 600).astype(np.int64)
    x = rng.randint(0, W, n + 600).astype(np.uint16)
    y = rng.randint(0, H, n + 600).astype(np.uint16)
    p = rng.randint(0, 2, n + 600).astype(np.int8)
    t[n:] = rng.randint(700_000, 703_000, 600)
    x[n:], y[n:], p[n:] = 5, 7, 1
    order = np.argsort(t, kind="stable")
    t, x, y, p = t[order], x[order], y[order], p[order]
    t[rng.choice(np.arange(1, n), 20, replace=False)] -= 3000
    t[0] = max(t[0], 0)
    h5f = raw / f"{name}_td.dat.h5"
    with h5py.File(str(h5f), "w") as f:
        g = f.create_group("events")
        for k, v in (("x", x), ("y", y), ("p", p), ("t", t)):
            g.create_dataset(k, data=v)
        g.create_dataset("height", data=H)
        g.create_dataset("width", data=W)
    rows = []
    for i, ts in enumerate(range(600_000, int(seconds * 1e6), 250_000)):
        rows += [(ts, 3.0, 4.0, 20.0, 15.0, 0, 0, 1.0),
                 (ts, W - 15.0, 10.0, 30.0, 12.0, 1, 1, 0.9),  # cropped
                 (ts, 10.0, 10.0, 3.0, 30.0, 0, 2, 1.0)]  # too narrow
        if i % 2:
            rows.append((ts, 0.0, 0.0, W - 1.0, 20.0, 1, 3, 1.0))  # wide
    npy = raw / f"{name}_bbox.npy"
    np.save(str(npy), np.array(rows, dtype=BBOX_DTYPE))
    return npy, h5f


@pytest.fixture
def small_hw(monkeypatch):
    for mod in (j_pp, t_pp):
        monkeypatch.setitem(mod.DATASET_HW, "gen1", HW)


@pytest.fixture(scope="module")
def raw_pair(tmp_path_factory):
    return make_raw(tmp_path_factory.mktemp("raw"), "rec")


def _h5_layout(path):
    assert blosc_h5.register_plugin()  # the blosc filter, to read back
    with h5py.File(str(path), "r") as f:
        ds = f["data"]
        plist = ds.id.get_create_plist()
        filters = [plist.get_filter(i)[:3]
                   for i in range(plist.get_nfilters())]
        return (ds.shape, ds.dtype, ds.chunks, filters), np.asarray(ds)


def same_trees(a, b):
    """Every file under ``a`` is under ``b`` with the same arrays (and the
    same HDF5 dataset layout and filter pipeline); returns the count."""
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".h5"):
            (la, xa), (lb, xb) = _h5_layout(pa), _h5_layout(pb)
            assert la == lb, rel
            np.testing.assert_array_equal(xa, xb, err_msg=rel)
        elif rel.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            xa, xb = np.load(pa), np.load(pb)
            assert xa.dtype == xb.dtype
            np.testing.assert_array_equal(xa, xb, err_msg=rel)
    assert any(f.endswith(".h5") for f in files)
    return len(files)


CASES = {
    "hist_dt_zstd": dict(),
    "hist_dt_nofast_lz4": dict(fastmode=False, compression="blosc-lz4"),
    "hist_ne_ds2_none": dict(ev_repr_delta_ts_ms=None,
                             ev_repr_num_events=3000, downsample_by_2=True,
                             compression="none"),
    "hist_cutoff_gzip_train": dict(count_cutoff=100, compression="gzip",
                                   split="train"),
    "hist_dt_numpy": dict(native=False),
    "hist_nofast_ds2_numpy": dict(fastmode=False, downsample_by_2=True,
                                  native=False),
    "mixed_dt_zstd": dict(representation="mixeddensity_stack"),
    "mixed_ne_cutoff_ds2_lz4": dict(representation="mixeddensity_stack",
                                    ev_repr_delta_ts_ms=None,
                                    ev_repr_num_events=3000, count_cutoff=10,
                                    downsample_by_2=True,
                                    compression="blosc-lz4"),
    "mixed_dt_none_numpy": dict(representation="mixeddensity_stack",
                                compression="none", native=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_recording_equals_jax(tmp_path, raw_pair, small_hw,
                                      monkeypatch, case):
    kw = dict(CASES[case])
    split = kw.pop("split", "val")
    if not kw.pop("native", True):  # both packages on the numpy voxelizers
        for mod in (j_native, t_native):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
    else:
        assert t_native.get_lib() is not None
    npy, h5f = raw_pair
    assert t_pp.process_recording(npy, h5f, tmp_path / "t", "gen1", split,
                                  **kw)
    assert j_pp.process_recording(npy, h5f, tmp_path / "j", "gen1", split,
                                  **kw)
    assert same_trees(tmp_path / "t", tmp_path / "j") == 5
    name = j_pp.default_repr_name(
        kw.get("representation", "stacked_histogram"), 10,
        kw.get("ev_repr_delta_ts_ms", 50), kw.get("ev_repr_num_events"),
        kw.get("count_cutoff"))
    assert t_pp.default_repr_name(
        kw.get("representation", "stacked_histogram"), 10,
        kw.get("ev_repr_delta_ts_ms", 50), kw.get("ev_repr_num_events"),
        kw.get("count_cutoff")) == name
    h5s = list((tmp_path / "t" / "event_representations_v2" / name).glob(
        "*.h5"))
    assert len(h5s) == 1 and "_in_progress" not in h5s[0].name
    data = _h5_layout(h5s[0])[1]
    assert data.any()
    if kw.get("representation") is None:  # the hot pixel: wrapped or not
        yx = (3, 2) if kw.get("downsample_by_2") else (7, 5)
        hot = data[:, :, yx[0], yx[1]]
        if kw.get("fastmode", True):
            assert 0 < hot.max() < 255
        else:
            assert hot.max() == 255


def test_rerun_checks_and_in_progress(tmp_path, raw_pair, small_hw):
    """A re-run over finished output returns True and leaves it as it was;
    a stale ``_in_progress`` file is replaced; labels that differ from
    the files on disk raise (match_if_exists); a recording whose labels
    the filters drop entirely is skipped, as in JAX."""
    npy, h5f = raw_pair
    out = tmp_path / "out"
    assert t_pp.process_recording(npy, h5f, out, "gen1", "val")
    rdir = (out / "event_representations_v2"
            / "stacked_histogram_dt=50_nbins=10")
    final = rdir / "event_representations.h5"
    before = _h5_layout(final)
    stamp = final.stat().st_mtime_ns
    assert t_pp.process_recording(npy, h5f, out, "gen1", "val")
    assert final.stat().st_mtime_ns == stamp  # a finished file is skipped
    final.unlink()
    (rdir / "event_representations_in_progress.h5").write_bytes(b"stale")
    assert t_pp.process_recording(npy, h5f, out, "gen1", "val")
    after = _h5_layout(final)
    assert after[0] == before[0]
    np.testing.assert_array_equal(after[1], before[1])
    assert not (rdir / "event_representations_in_progress.h5").exists()
    labels = np.load(str(npy))
    labels["x"] += 1.0
    moved = tmp_path / "moved_bbox.npy"
    np.save(str(moved), labels)
    for mod in (t_pp, j_pp):
        with pytest.raises(AssertionError, match="re-run mismatch"):
            mod.process_recording(moved, h5f, out, "gen1", "val")
    labels["w"] = 2.0
    np.save(str(moved), labels)
    for mod in (t_pp, j_pp):
        assert not mod.process_recording(moved, h5f, tmp_path / mod.__name__,
                                         "gen1", "val")


def test_main_equals_jax(tmp_path, monkeypatch, capsys):
    """``main`` over a raw tree (two splits, a recording on the ignore
    list, a label file without events) with a spawn pool of 2 writes the
    tree and prints the lines that JAX's serial ``main`` does, at the
    sensor's 240x304."""
    for split, names in (("train", ("r0",)),
                         ("val", ("r1", j_pp.DIRS_TO_IGNORE["gen1"][0]))):
        raw = tmp_path / "raw" / split
        raw.mkdir(parents=True)
        for i, name in enumerate(names):
            make_raw(raw, name, hw=(240, 304), seconds=1.2, n_events=20_000,
                     seed=10 + i)
    np.save(str(tmp_path / "raw" / "val" / "lone_bbox.npy"),
            np.zeros(0, BBOX_DTYPE))
    args = ["--input_dir", str(tmp_path / "raw"), "--dataset", "gen1",
            "--splits", "train", "val", "--nbins", "5",
            "--compression", "blosc-lz4"]
    t_pp.main(args + ["--output_dir", str(tmp_path / "t"),
                      "--num_processes", "2"])
    got = capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["preprocess"] + args + [
        "--output_dir", str(tmp_path / "j")])
    j_pp.main()
    assert got == capsys.readouterr().out == "r0: ok\nr1: ok\n"
    assert same_trees(tmp_path / "t", tmp_path / "j") == 10


# -- native library ----------------------------------------------------------


def test_native_lib_equals_jax():
    """The port loads the in-repo library (the JAX package's file) and
    binds the same four functions to the same results."""
    assert t_native._LIB_PATH == j_native._LIB_PATH
    assert t_native.get_lib() is not None
    rng = np.random.RandomState(0)
    n = 5000
    x, y = rng.randint(0, 64, n), rng.randint(0, 48, n)
    p, t = rng.randint(0, 2, n), np.sort(rng.randint(0, 50_000, n))
    for fast in (False, True):
        np.testing.assert_array_equal(
            t_native.stacked_histogram_u8(x, y, p, t, 5, 48, 64, 200, fast),
            j_native.stacked_histogram_u8(x, y, p, t, 5, 48, 64, 200, fast))
    for cutoff in (None, 3):
        np.testing.assert_array_equal(
            t_native.mixed_density_stack_i8(x, y, p, t, 5, 48, 64, cutoff),
            j_native.mixed_density_stack_i8(x, y, p, t, 5, 48, 64, cutoff))
    tt = rng.randint(0, 100, 50).astype(np.int64)
    np.testing.assert_array_equal(t_native.time_running_max(tt.copy()),
                                  np.maximum.accumulate(tt))
    ious = rng.rand(7, 5)
    gi = np.array([0, 0, 0, 1, 1], np.uint8)
    oor = rng.rand(7) < 0.3
    thrs = np.linspace(0.5, 0.95, 10)
    for a, b in zip(t_native.coco_match_image(ious, gi, thrs, oor),
                    j_native.coco_match_image(ious, gi, thrs, oor)):
        np.testing.assert_array_equal(a, b)


def _coco_scene(seed):
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for _ in range(8):
        n, m = rng.randint(1, 5), rng.randint(0, 6)
        g = np.zeros((n, 5))
        g[:, :2] = rng.uniform(0, 200, (n, 2))
        g[:, 2:4] = rng.uniform(8, 90, (n, 2))
        g[:, 4] = rng.randint(0, 2, n)
        d = np.zeros((m, 6))
        d[:, :2] = rng.uniform(0, 200, (m, 2))
        d[:, 2:4] = rng.uniform(8, 90, (m, 2))
        d[:, 4] = rng.randint(0, 2, m)
        d[:, 5] = rng.uniform(0.1, 1, m)
        k = min(n, m)  # near-perfect detections on top
        d[:k, :4] = g[:k, :4] + rng.normal(0, 2, (k, 4))
        d[:k, 4] = g[:k, 4]
        gts.append(g)
        dts.append(d)
    return gts, dts


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_coco_matcher_equals_python(monkeypatch, seed):
    """The port's coco.py gives the same metrics with its native matcher
    and without (tests/test_native.py holds JAX's the same way), and the
    per-image matches are the same arrays."""
    from rvt_tpu_torch.evaluation import coco

    assert t_native.get_lib() is not None
    gts, dts = _coco_scene(seed)
    with_native = coco.evaluate_coco_map(gts, dts, num_classes=2)
    rng = np.random.RandomState(seed)
    ious = rng.rand(9, 6) * (rng.rand(9, 6) < 0.7)
    gi = np.sort(rng.rand(6) < 0.3)
    oor = rng.rand(9) < 0.3
    native = coco._match_img(ious, gi, oor)
    monkeypatch.setattr(t_native, "coco_match_image", lambda *a, **k: None)
    without = coco.evaluate_coco_map(gts, dts, num_classes=2)
    assert with_native == without
    assert 0.0 < with_native["AP"] < 1.0
    for a, b in zip(native, coco._match_img(ious, gi, oor)):
        assert a.dtype == b.dtype == bool
        np.testing.assert_array_equal(a, b)


# -- ops/voxelization.py: the XLA functions in eager torch -------------------


VOX = [  # N, num_events, bins, H, W, count_cutoff
    (5000, 5000, 10, 24, 30, 127),
    (4096, 3000, 10, 60, 76, 127),   # padded tail
    (3000, 1000, 5, 16, 20, 3),      # clipped
    (100, 0, 10, 8, 8, 127),         # num_events 0
    (200, 1, 3, 8, 8, 127),
]


@pytest.mark.parametrize("case", range(len(VOX)))
def test_mixed_density_stack_equals_jax(case):
    import jax.numpy as jnp

    from rvt_tpu.ops import voxelization as jv
    from rvt_tpu_torch.ops import voxelization as tv

    N, n, bins, H, W, cutoff = VOX[case]
    rng = np.random.RandomState(case)
    x = rng.randint(0, W, N).astype(np.int32)
    y = rng.randint(0, H, N).astype(np.int32)
    p = rng.randint(0, 2, N).astype(np.int32)
    t = np.sort(rng.randint(0, 50_000, N)).astype(np.int32)
    # a bin edge hit exactly: t_norm = 2**-k for k = 1..4
    t[:n][-1:] = 48_000
    t[1:5] = t[0] + (48_000 - t[0]) // np.array([2, 4, 8, 16])
    t[:n] = np.sort(t[:n])
    x[n:], y[n:], p[n:] = 10 ** 6, -5, 7  # padding that must be dropped
    ref = np.asarray(jv.mixed_density_stack(
        *(jnp.asarray(a) for a in (x, y, p, t)), jnp.int32(n), bins=bins,
        height=H, width=W, count_cutoff=cutoff))
    got = tv.mixed_density_stack(*(torch.from_numpy(a) for a in (x, y, p, t)),
                                 n, bins, H, W, count_cutoff=cutoff)
    assert got.dtype == torch.int8 and ref.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != 0).any() == (n > 0)


def test_repair_time_monotonicity_equals_jax():
    import jax.numpy as jnp

    from rvt_tpu.ops import voxelization as jv
    from rvt_tpu_torch.ops import voxelization as tv

    rng = np.random.RandomState(0)
    for n in (7, 65_537):
        t = np.sort(rng.randint(0, 10 ** 6, n)).astype(np.int32)
        t[rng.randint(0, n, max(1, n // 10))] -= 500
        got = tv.repair_time_monotonicity(torch.from_numpy(t))
        ref = np.asarray(jv.repair_time_monotonicity(jnp.asarray(t)))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(ref, np.maximum.accumulate(t))
