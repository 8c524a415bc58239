"""K1 ``ln_rows`` and ``train_reduce`` (``sum_parts``, ``col_sum``,
``layer_scale_bwd``) of the port on the CPU: their plain versions against
the JAX package's LayerNorm (``rvt_tpu/ops/fused_attention.py:
_layer_norm_f32``) and the jnp column sums of its training kernels
(``rvt_tpu/ops/fused_train.py:_block_bwd``, ``_acc``); and, on the
fake-CUDA stand-in of ``test_torch_wrappers.py``, the launch plans the
wrappers hand the CUDA kernels."""
import ctypes
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rvt_tpu.ops.fused_attention import _layer_norm_f32
from rvt_tpu_torch.ops import fused_attention as fa
from rvt_tpu_torch.ops import kernels
from tests.test_torch_wrappers import _FakeLib, fake_cuda  # noqa: F401

PRESET_C = [32, 48, 64, 96, 128, 192, 256, 384, 512]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes (parallel test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp (8 significant bits) at each |x|."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", PRESET_C)
def test_ln_rows_plain_matches_jax(C, dtype):
    """The plain K1 (f32 statistics, fast variance, f32 affine, bf16
    result) against ``_layer_norm_f32`` on the same rows, to one bf16 ulp;
    with ``with_f32`` the f32 copy is the bf16 result widened."""
    rng = np.random.RandomState(C)
    x = (rng.randn(37, C) * 2.0 + 0.5).astype(np.float32)
    s = (rng.randn(C) * 0.2 + 1.0).astype(np.float32)
    b = (rng.randn(C) * 0.2).astype(np.float32)
    bf = jnp.bfloat16
    xj = jnp.asarray(x, bf) if dtype == "bf16" else jnp.asarray(x)
    ref = _layer_norm_f32(xj.astype(jnp.float32), jnp.asarray(s, bf),
                          jnp.asarray(b, bf), 1e-5)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.bfloat16()
    st, bt = torch.from_numpy(s).bfloat16(), torch.from_numpy(b).bfloat16()
    y, yf = fa.ln_rows(xt, st, bt, 1e-5, with_f32=True)
    assert y.dtype == torch.bfloat16 and torch.equal(yf, y.float())
    err = np.abs(y.float().numpy() - ref)
    assert (err <= _bf16_ulp(ref)).all(), float(err.max())


@pytest.mark.parametrize("C", [32, 96, 512])
def test_layer_scale_bwd_matches_jax_sums(C):
    """``layer_scale_bwd`` on the CPU against ``_block_bwd``'s jnp sums of
    one LayerScale: dm = dR * gamma (bf16 for the next product, bit for
    bit), the bias gradient sum(dm) and the gamma gradient sum(f32(v) *
    dR) (:369-374, :394-404), to 1e-6 of max|ref|."""
    rng = np.random.RandomState(C)
    M = 203
    dR = rng.randn(M, C).astype(np.float32)
    v = rng.randn(M, C).astype(np.float32)
    g = (rng.randn(C) * 0.3).astype(np.float32)
    vj = jnp.asarray(v, jnp.bfloat16)
    dm = jnp.asarray(dR) * jnp.asarray(g).reshape(1, -1)
    ref_d = np.asarray(dm.astype(jnp.bfloat16).astype(jnp.float32))
    ref_b = np.asarray(jnp.sum(dm, axis=0))
    ref_g = np.asarray(jnp.sum(vj.astype(jnp.float32) * jnp.asarray(dR),
                               axis=0))
    d, db, dg = fa.layer_scale_bwd(torch.from_numpy(dR),
                                   torch.from_numpy(v).bfloat16(),
                                   torch.from_numpy(g))
    assert d.dtype == torch.bfloat16
    np.testing.assert_array_equal(d.float().numpy(), ref_d)
    assert _rel(db.numpy(), ref_b) <= 1e-6
    assert _rel(dg.numpy(), ref_g) <= 1e-6


@pytest.mark.parametrize("C", [32, 96, 512])
def test_col_sum_matches_jax_qkv_bias_sum(C):
    """``col_sum`` of the bf16 dqkv against ``_block_bwd``'s
    ``jnp.sum(dqkv.astype(f32), 0)`` (:415), to 1e-6 of max|ref|."""
    rng = np.random.RandomState(C)
    dq = rng.randn(157, 3 * C).astype(np.float32)
    ref = np.asarray(jnp.sum(jnp.asarray(dq, jnp.bfloat16).astype(
        jnp.float32), axis=0))
    got = fa.col_sum(torch.from_numpy(dq).bfloat16())
    assert got.dtype == torch.float32 and got.shape == (3 * C,)
    assert _rel(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("shape", [(13, 256), (5, 2, 64), (3, 40, 48)])
def test_sum_parts_matches_jax_grid_accumulation(shape):
    """``sum_parts`` against the sequential grid's accumulation of the JAX
    kernels (``_acc``: the first partial, then each later one added in
    grid order), to 1e-6 of max|ref|."""
    part = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    ref = functools.reduce(lambda acc, p: acc + p,
                           [jnp.asarray(p) for p in part])
    got = fa.sum_parts(torch.from_numpy(part))
    assert tuple(got.shape) == shape[1:]
    assert _rel(got.numpy(), np.asarray(ref)) <= 1e-6


# ---------------------------------------------------------------------------
# The launch plans (fake CUDA)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("C", PRESET_C + [40, 100, 33])
def test_ln_rows_plan_covers_every_column_once(C, itemsize):
    """K1's lane map: lane l of a row's group takes vectors l, l + group,
    ... of the row; every column of the row lands on exactly one lane,
    none past C is stored. At the presets' widths the loads are 16 bytes
    and no lane is idle."""
    plan = fa.ln_rows_plan(C, itemsize)
    assert plan.group in (1, 2, 4, 8, 16, 32) and 1 <= plan.nv <= 8
    nvec = C // plan.vec
    cols = [(k * plan.group + lane) * plan.vec + e
            for lane in range(plan.group) for k in range(plan.nv)
            if k * plan.group + lane < nvec for e in range(plan.vec)]
    assert sorted(cols) == list(range(C))
    if C in PRESET_C:
        assert plan.vec * itemsize == 16
        assert plan.group * plan.nv == nvec and plan.nv <= 4


@pytest.mark.parametrize("C", [64, 192, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_rows_passes_its_plan(fake_cuda, C, dtype):  # noqa: F811
    """The wrapper hands the launcher K1's plan for C and the input type
    and the card's SM count, and one launch is counted."""
    n = fa.LN_ROWS.launches
    x = torch.randn(40, C).to(dtype)
    y, yf = fa.ln_rows(x, torch.ones(C).bfloat16(), torch.zeros(C).bfloat16(),
                       1e-5, with_f32=True)
    assert y.shape == yf.shape == (40, C) and fa.LN_ROWS.launches == n + 1
    (fn, args), = _FakeLib.launches
    assert fn == "rvt_ln_rows" and args[6:8] == (40, C)
    assert args[9:12] == tuple(fa.ln_rows_plan(C, x.element_size()))
    assert args[12] == 132 and args[5] is not None


# (M, N) of the split sums on the gen1 RVT-B train step and its per-step
# path: K2's gelu partials, K5's, K6's, K8's db, the LayerScale backward
# and the qkv-bias sums, a few rows, a ragged width
_REDUCE_SHAPES = [(13440, 256), (3360, 512), (210, 2048), (1024, 128),
                  (860160, 64), (860160, 192), (53760, 768), (13440, 1536),
                  (40960, 64), (640, 512), (4, 1048576), (2, 2097152),
                  (5, 37), (1, 8), (1280, 256)]


@pytest.mark.parametrize("M,N", _REDUCE_SHAPES)
def test_reduce_plan(M, N):
    """Every row in exactly one chunk, every column vector in one tile of at
    most 256 threads, no more column tiles than tickets where the rows are
    split, at most ``_RED_FINAL`` partials a thread of the finishing block,
    and vectors that divide N."""
    for itemsize in (4, 2):
        p = fa.reduce_plan(M, N, itemsize)
        assert N % p.vec == 0 and p.vec * itemsize <= 16
        assert (p.chunks - 1) * p.rows < M <= p.chunks * p.rows
        assert p.tx * p.ty <= 256 and p.ty >= 1 and p.tx >= 1
        tiles = p.blocks(N) // p.chunks
        assert tiles == -(-(N // p.vec) // p.tx)
        if p.chunks > 1:
            assert tiles <= fa._RED_TICKETS
            assert -(-p.chunks // p.ty) <= fa._RED_FINAL


def test_reduce_plan_fills_the_card_on_tall_narrow_partials():
    """K2's gelu-backward partials at gen1 stage 1, [13440, 4C = 256] f32,
    are split into row chunks as well as column tiles: at least ~264
    blocks (two an SM of an H100), where one block a column tile gave 8."""
    p = fa.reduce_plan(13440, 256)
    assert p.chunks > 1 and p.blocks(256) >= 264


def _reduce_calls():
    """One call of each train_reduce wrapper on small CPU tensors."""
    fa.sum_parts(torch.randn(300, 2, 64))
    fa.col_sum(torch.randn(999, 96).bfloat16())
    fa.layer_scale_bwd(torch.randn(999, 64), torch.randn(999, 64).bfloat16(),
                       torch.ones(64))


def test_reduce_wrappers_pass_their_plan(fake_cuda):  # noqa: F811
    """Each wrapper launches once and hands its launcher the plan of its
    shape (the same on a card of any SM count), then the partials'
    workspace and the tickets."""
    n = fa.TRAIN_REDUCE.launches
    _reduce_calls()
    assert fa.TRAIN_REDUCE.launches == n + 3
    assert fake_cuda == ["rvt_sum_parts", "rvt_colsum", "rvt_ls_bwd"]
    (_, sp), (_, cs), (_, ls) = _FakeLib.launches
    assert sp[2:9] == (300, 128) + tuple(fa.reduce_plan(300, 128))
    assert cs[3:10] == (999, 96) + tuple(fa.reduce_plan(999, 96, 2))
    assert ls[5:12] == (999, 64) + tuple(fa.reduce_plan(999, 64))
    assert all(a[-3] is not None and a[-2] is not None
               for a in (sp, cs, ls))


def test_reduce_plan_does_not_depend_on_the_card(fake_cuda,  # noqa: F811
                                                 monkeypatch):
    """The launch arguments other than pointers are the same whatever the
    card's SM count, so the summation order is too."""
    sigs = kernels.SIGNATURES["train_reduce"]
    runs = []
    for sms in (132, 78, 16):
        monkeypatch.setattr(fa, "sm_count", lambda t, s=sms: s)
        _FakeLib.launches = []
        _reduce_calls()
        runs.append([(fn,) + tuple(a for a, t in zip(args, sigs[fn])
                                   if t is not ctypes.c_void_p)
                     for fn, args in _FakeLib.launches])
    assert len(runs[0]) == 3 and runs[0] == runs[1] == runs[2]
