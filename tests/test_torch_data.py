"""The port's copies of the data layer (rvt_tpu_torch.data: blosc_h5,
labels, sequence, streaming, loader; ops/s2d.host_depth_to_space) against
the JAX package's, bit for bit on the CPU, over recordings that the JAX
package's preprocess writes in the production layout
(tests/test_eval_loop.py:make_mini_gen1_dataset)."""
import pickle
from dataclasses import astuple, fields

import numpy as np
import pytest

from rvt_tpu.data import labels as j_labels
from rvt_tpu.data import sequence as j_seq
from rvt_tpu.data import streaming as j_stream
from rvt_tpu.data.loader import ParallelBatchLoader as JLoader
from rvt_tpu.ops import s2d as j_s2d
from rvt_tpu_torch.data import labels as t_labels
from rvt_tpu_torch.data import sequence as t_seq
from rvt_tpu_torch.data import streaming as t_stream
from rvt_tpu_torch.data.loader import ParallelBatchLoader, make_loader
from rvt_tpu_torch.ops import s2d as t_s2d

from .test_eval_loop import make_mini_gen1_dataset

REPR = "stacked_histogram_dt=50_nbins=10"
HW = (64, 80)
T = 5


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_mini_gen1_dataset(tmp_path_factory.mktemp("data"),
                                  names=("a", "b", "c"))


def _recs(module, data, **kw):
    return [module.Recording(p, REPR, original_hw=HW, max_labels_per_frame=8,
                             **kw) for p in sorted(data.iterdir())]


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


@pytest.mark.parametrize("raw_chunks", [False, True],
                         ids=["plugin", "raw_chunks"])
def test_recording_reads_equal_jax(data, raw_chunks):
    """Event tensors through the HDF5 filter plugin and through the ctypes
    chunk reader, labels, index maps: as JAX's reader gives them; a
    pickled copy (process-mode loading) reads the same."""
    refs = _recs(j_seq, data)
    for rec, ref in zip(_recs(t_seq, data, prefer_raw_chunks=raw_chunks),
                        refs):
        assert (rec.num_ev_repr, rec.ev_shape, rec.ev_dtype) == (
            ref.num_ev_repr, ref.ev_shape, ref.ev_dtype)
        ev = rec.read_ev_repr(0, rec.num_ev_repr)
        np.testing.assert_array_equal(ev, ref.read_ev_repr(0,
                                                           ref.num_ev_repr))
        assert ev.any()
        np.testing.assert_array_equal(rec.objframe_idx_2_repr_idx,
                                      ref.objframe_idx_2_repr_idx)
        np.testing.assert_array_equal(rec.label_store.labels,
                                      ref.label_store.labels)
        for r in range(rec.num_ev_repr):
            a, b = rec.labels_at_repr_idx(r), ref.labels_at_repr_idx(r)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        clone = pickle.loads(pickle.dumps(rec))
        np.testing.assert_array_equal(clone.read_ev_repr(3, 9), ev[3:9])
        rec.close()
        clone.close()


def test_raw_chunk_reads_hold_h5pys_lock(data):
    """The ctypes chunk reader takes h5py's global lock for its raw IO:
    ``read_direct_chunk`` runs outside it and races with every other
    HDF5 call of the process (JAX's copy locks per dataset; under load
    its thread-mode loader fails with "no VOL object wrap context").
    Eight threads reading every recording's frames give the plugin's
    bytes."""
    import h5py
    from concurrent.futures import ThreadPoolExecutor

    from rvt_tpu_torch.data import blosc_h5

    recs = _recs(t_seq, data, prefer_raw_chunks=True)
    refs = [r.read_ev_repr(0, r.num_ev_repr) for r in _recs(t_seq, data)]
    assert all(isinstance(r._handle(), blosc_h5.BloscChunkDataset)
               and r._handle()._io_lock is h5py._objects.phil for r in recs)
    jobs = [(i, s) for _ in range(4) for i, r in enumerate(recs)
            for s in range(0, r.num_ev_repr - 4, 3)]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda j: recs[j[0]].read_ev_repr(j[1],
                                                              j[1] + 4),
                            jobs))
    for (i, s), ev in zip(jobs, got):
        np.testing.assert_array_equal(ev, refs[i][s:s + 4])


def test_stream_views_equal_jax(data):
    """Every window of each recording's StreamView, the label-dense
    sub-streams' ranges and windows, and the fully padded fill window."""
    for rec, ref in zip(_recs(t_seq, data), _recs(j_seq, data)):
        view, jview = t_seq.StreamView(rec, T), j_seq.StreamView(ref, T)
        assert view.start_indices == jview.start_indices
        assert view.stop_indices == jview.stop_indices
        for i in range(len(view)):
            _same_window(view[i], jview[i])
        subs = t_seq.StreamView.with_guaranteed_labels(rec, T)
        jsubs = j_seq.StreamView.with_guaranteed_labels(ref, T)
        assert [(s.start_indices, s.stop_indices) for s in subs] == [
            (s.start_indices, s.stop_indices) for s in jsubs]
        for s, js in zip(subs, jsubs):
            _same_window(s[len(s) - 1], js[len(js) - 1])
        _same_window(rec.padded_window(T), ref.padded_window(T))


@pytest.mark.parametrize("end_labels", [False, True],
                         ids=["all_labels", "end_labels"])
def test_random_access_views_equal_jax(data, end_labels):
    for rec, ref in zip(_recs(t_seq, data), _recs(j_seq, data)):
        view = t_seq.RandomAccessView(rec, T, only_load_end_labels=end_labels)
        jview = j_seq.RandomAccessView(ref, T,
                                       only_load_end_labels=end_labels)
        assert len(view) == len(jview) > 0
        for i in range(len(view)):
            _same_window(view[i], jview[i])


def test_range_indices_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        idx = np.sort(rng.choice(400, rng.randint(1, 40), replace=False))
        for max_len in (1, 5, 21):
            assert t_seq.ev_repr_range_indices(idx, max_len) == \
                j_seq.ev_repr_range_indices(idx, max_len)


@pytest.mark.parametrize("shard,shards", [(0, 1), (0, 2), (1, 2)])
def test_eval_scheduler_equals_jax(data, shard, shards):
    """Every Batch field of the eval scheduler: three recordings on two
    lanes (one lane changes recording), and two shards of them (the
    shard of one recording fills its second lane with padded windows)."""
    views = [t_seq.StreamView(r, T) for r in _recs(t_seq, data)]
    jviews = [j_seq.StreamView(r, T) for r in _recs(j_seq, data)]
    sched = t_stream.EvalStreamScheduler(views, 2, shard_index=shard,
                                         num_shards=shards)
    ref = j_stream.EvalStreamScheduler(jviews, 2, shard_index=shard,
                                       num_shards=shards)
    assert len(sched) == len(ref) > 0
    plans = [[astuple(p) for p in b] for b in sched.plan_batches()]
    assert plans == [[astuple(p) for p in b] for b in ref.plan_batches()]
    got, want = list(sched), list(ref)
    assert len(got) == len(want) == len(sched)
    for a, b in zip(got, want):
        _same_batch(a, b)
    if shards == 1:
        assert any(b.is_first_sample.any() for b in got[1:])
    if shard == 1:
        assert any(p[1] < 0 for b in plans for p in b)


def test_train_scheduler_equals_jax(data):
    """The label-dense streams' shuffled lanes from one seed (no
    augmentation: the augmentor is not ported yet)."""
    streams = [s for r in _recs(t_seq, data)
               for s in t_seq.StreamView.with_guaranteed_labels(r, T)]
    jstreams = [s for r in _recs(j_seq, data)
                for s in j_seq.StreamView.with_guaranteed_labels(r, T)]
    sched = t_stream.TrainStreamScheduler(streams, 3, seed=7)
    ref = j_stream.TrainStreamScheduler(jstreams, 3, seed=7)
    n = 2 * max(len(s) for s in streams) + 3
    for _, a, b in zip(range(n), sched, ref):
        _same_batch(a, b)
        a.validate()


@pytest.mark.parametrize("mode,workers", [("thread", 0), ("thread", 3),
                                          ("process", 2)])
def test_loader_equals_serial_and_jax(data, mode, workers):
    """The pooled loader gives the serial batches in plan order, as JAX's
    loader gives them, with a host transform applied after stacking."""
    views = [t_seq.StreamView(r, T) for r in _recs(t_seq, data)]
    jviews = [j_seq.StreamView(r, T) for r in _recs(j_seq, data)]
    serial = list(t_stream.EvalStreamScheduler(views, 2))

    def transform(b):
        b.ev_repr = b.ev_repr[..., :4]
        return b

    loader = ParallelBatchLoader(t_stream.EvalStreamScheduler(views, 2),
                                 workers, mode=mode, prefetch_batches=2,
                                 transform=transform)
    jloader = JLoader(j_stream.EvalStreamScheduler(jviews, 2), workers,
                      mode=mode, prefetch_batches=2, transform=transform)
    got, want = list(loader), list(jloader)
    assert len(got) == len(want) == len(serial) == len(loader)
    for a, b, s in zip(got, want, serial):
        _same_batch(a, b)
        np.testing.assert_array_equal(a.ev_repr, s.ev_repr[..., :4])
        np.testing.assert_array_equal(a.labels, s.labels)
    assert make_loader(loader.scheduler) is loader.scheduler


def _random_labels(rng, n, hw):
    h, w = hw
    x, y = rng.uniform(-10, w, n), rng.uniform(-10, h, n)
    out = np.stack([np.full(n, 1e6), x, y, rng.uniform(0, w / 2, n),
                    rng.uniform(0, h / 2, n), rng.randint(0, 3, n),
                    rng.uniform(0, 1, n)], 1).astype(np.float32)
    out[:2, 3] = 0.0  # flat boxes
    return out


LABEL_FNS = {
    "clamp_to_frame": lambda m, l, hw: m.clamp_to_frame(l, hw),
    "remove_flat": lambda m, l, hw: m.remove_flat(l),
    "scale": lambda m, l, hw: m.scale(l, hw, 0.6)[0],
    "scale_hw": lambda m, l, hw: np.asarray(m.scale(l, hw, 1.5)[1]),
    "flip_lr": lambda m, l, hw: m.flip_lr(l, hw),
    "rotate": lambda m, l, hw: m.rotate(l, hw, 17.0),
    "zoom_in": lambda m, l, hw: m.zoom_in_and_rescale(l, hw, (7, 5), 1.4),
    "zoom_out": lambda m, l, hw: m.zoom_out_and_rescale(l, hw, (9, 3), 1.7),
    "to_yolox": lambda m, l, hw: m.to_yolox_format(l),
    "pad": lambda m, l, hw: np.concatenate(
        [a.reshape(len(a), -1).astype(np.float32)
         for a in m.pad_labels(l, 8)], 1),
}


@pytest.mark.parametrize("name", sorted(LABEL_FNS))
def test_label_functions_equal_jax(name):
    fn = LABEL_FNS[name]
    rng = np.random.RandomState(3)
    for n in (0, 5, 12):
        for hw in ((64, 80), (240, 304)):
            labels = _random_labels(rng, n, hw)
            a = fn(t_labels, labels.copy(), hw)
            b = fn(j_labels, labels.copy(), hw)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("factor", [None, 2])
def test_label_store_equals_jax(factor):
    rng = np.random.RandomState(5)
    arr = np.zeros(10, dtype=[(k, "<f4") for k in (
        "t", "x", "y", "w", "h", "class_id", "class_confidence")])
    for k in arr.dtype.names:
        arr[k] = rng.uniform(0, 200, 10)
    offsets = np.array([0, 3, 3, 7])
    a = t_labels.LabelStore.from_structured_array(arr, offsets, (240, 304),
                                                  factor)
    b = j_labels.LabelStore.from_structured_array(arr, offsets, (240, 304),
                                                  factor)
    assert len(a) == len(b) == 4
    for i in range(4):
        np.testing.assert_array_equal(a[i], b[i])


@pytest.mark.parametrize("hw,target", [((64, 80), (64, 96)),
                                       ((240, 304), (256, 320))])
def test_depth_to_space_inverts_space_to_depth(hw, target):
    rng = np.random.RandomState(0)
    ev = rng.randint(0, 255, (2, 3) + hw + (20,)).astype(np.uint8)
    blocked = t_s2d.host_space_to_depth(ev, target)
    np.testing.assert_array_equal(blocked,
                                  j_s2d.host_space_to_depth(ev, target))
    back = t_s2d.host_depth_to_space(blocked, hw, 20)
    np.testing.assert_array_equal(back, ev)
    np.testing.assert_array_equal(
        back, j_s2d.host_depth_to_space(blocked, hw, 20))


# (storage hw, model hw): gen1 tiny, gen1 and gen4 (ds2 half resolution)
@pytest.mark.parametrize("hw,target", [((64, 80), (64, 96)),
                                       ((240, 304), (256, 320)),
                                       ((360, 640), (384, 640))])
def test_device_space_to_depth_equals_jax_and_host(hw, target):
    """``device_space_to_depth`` (the validation loop's and the Trainer's
    s2d on the card) against JAX's and against ``host_space_to_depth``,
    bit for bit."""
    import jax.numpy as jnp
    import torch

    rng = np.random.RandomState(1)
    ev = rng.randint(0, 255, (1, 2) + hw + (20,)).astype(np.uint8)
    got = t_s2d.device_space_to_depth(torch.from_numpy(ev), target)
    assert got.is_contiguous() and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  t_s2d.host_space_to_depth(ev, target))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_s2d.device_space_to_depth(
            jnp.asarray(ev), target)))


@pytest.mark.parametrize("stem_s2d", [False, True])
def test_feed_inverts_the_stack_view_without_a_copy(stem_s2d):
    """``_stack`` returns the window as a channel-last view of the stacked
    [B, T, C, H, W] buffer; the feed takes that buffer back as a view (no
    host copy), and on the CPU its tensors share the arrays' memory; laid
    out again (``window_input``), the window equals what the host path
    made: the contiguous channel-last copy, or, for an s2d stem, the
    channel-last view itself (no copy), which the steps' ``window_s2d``
    blocks into the host s2d's values, T-major."""
    import torch

    from rvt_tpu_torch.training.feed import (PinnedFeed, stored_layout,
                                             window_input)

    rng = np.random.RandomState(2)
    T, hw, target = 3, (40, 56), (64, 64)
    dicts = [dict(ev_repr=rng.randint(0, 9, (T, 20) + hw).astype(np.uint8),
                  labels=np.zeros((T, 2, 7), np.float32),
                  label_mask=np.zeros((T, 2), bool),
                  frame_valid=np.ones(T, bool), is_first_sample=False,
                  is_padded=np.zeros(T, bool)) for _ in range(2)]
    batch = t_stream._stack(dicts)
    stored, is_view = stored_layout(batch.ev_repr)
    assert is_view and stored.flags.c_contiguous
    assert stored.base is not None and np.shares_memory(stored,
                                                        batch.ev_repr)
    assert stored.shape == (2, T, 20) + hw
    # an array that is not such a view goes as it is
    own = np.ascontiguousarray(batch.ev_repr)
    assert stored_layout(own)[0] is own and not stored_layout(own)[1]
    ev, fv = PinnedFeed("cpu")([stored, batch.frame_valid])
    assert np.shares_memory(ev.numpy(), stored)
    assert torch.equal(fv, torch.from_numpy(batch.frame_valid))
    got = window_input(ev, True, target, stem_s2d)
    np.testing.assert_array_equal(got.numpy(), batch.ev_repr)
    if not stem_s2d:
        assert got.is_contiguous()
        return
    assert np.shares_memory(got.numpy(), stored)
    blocked = t_s2d.host_space_to_depth(batch.ev_repr, target)
    np.testing.assert_array_equal(
        t_s2d.window_s2d(got, target).float().numpy(),
        blocked.swapaxes(0, 1).astype(np.float32))
